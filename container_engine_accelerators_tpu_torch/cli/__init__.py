"""Command-line entry points of the port (serve, loadgen, trace,
generate, train, inject_fault)."""
