"""Models of the port: the Llama config and weights, and the decode path."""
