"""The plain reference: PyTorch in float32, nothing of the program."""
