"""The plain reference that decides ``correct``: PyTorch in float32 with TF32
off, written from the configuration, importing nothing of the program."""
