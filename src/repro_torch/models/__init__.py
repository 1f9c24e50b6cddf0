"""The LM stack of the port: parameter specs, layers and the dense transformer."""
