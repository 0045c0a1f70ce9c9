"""The plain reference of the engine's semantics (plain PyTorch, no part of
the program): scene arrays from a description, and the frame."""
