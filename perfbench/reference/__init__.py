"""The plain reference: float32 PyTorch with TF32 off, written from the
published equations.  It imports neither JAX nor anything of the program
(``har_tpu_torch``), and reads the program's results only to judge them.
"""
