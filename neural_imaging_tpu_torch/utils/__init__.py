"""Device handling for the port."""
