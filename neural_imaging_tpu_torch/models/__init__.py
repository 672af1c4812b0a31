"""Models: checkpoint I/O, INet, the differentiable JPEG and the FAN."""
