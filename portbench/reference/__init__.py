"""The plain reference the benchmark compares the port with."""
