"""Drivers of the program, one per kind of configuration."""
