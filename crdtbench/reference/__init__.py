"""The plain reference and the comparison that decides ``correct``.
Plain NumPy and Python: nothing here imports the program, JAX or the
JAX package."""
