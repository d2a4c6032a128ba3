"""Stdlib-only helpers the runtime shares with the controller: the
metrics registry and the clock."""
