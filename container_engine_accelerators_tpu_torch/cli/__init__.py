"""Command-line entry points of the port (serve, generate, train,
inject_fault)."""
