"""Training of the port: the multiscale losses and the four-group optimizer."""
