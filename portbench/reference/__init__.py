"""The plain reference that decides ``correct`` (f64 torch, nothing of the program)."""
