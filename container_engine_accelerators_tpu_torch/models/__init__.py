"""Models of the port: the Llama config, weights and training forward,
and the decode path."""
