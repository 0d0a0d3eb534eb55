"""Plain references of the configurations: PyTorch, independent of the port."""
