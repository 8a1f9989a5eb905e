"""The plain reference the output check holds the program against: plain
float32 PyTorch, frozen copies of the program's plain versions, importing
nothing of the program, of JAX or of the JAX package."""
