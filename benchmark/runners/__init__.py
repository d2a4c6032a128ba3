"""Runners: what drives the port for a kind of cell.  A runner module
has `Runner(ctx)` with `setup()`, `unit()` (one unit of work, returning
its size), `boundary()` (waits for the unit before the last), `free()`
and `check()` (the comparison with the reference).  `train` drives
`setup_training` and its `train_step`; `decode` drives `generate`."""
