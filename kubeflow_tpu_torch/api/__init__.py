"""The part of the Notebook API the GPU workload renderer reads: the
`spec.gpu` block and a read-only view of a Notebook CR dict."""
