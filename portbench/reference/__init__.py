"""The plain reference: the operator rebuilt from the cell's triplets and
its products and CG in plain PyTorch, in f64 for the judge and in a lower
precision for the control.  It imports nothing of the program and takes
nothing the program made."""
