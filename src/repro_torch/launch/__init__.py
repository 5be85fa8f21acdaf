"""Launch layer of the port: the serving driver."""
