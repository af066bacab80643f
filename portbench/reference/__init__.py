"""Plain PyTorch references, in float32 with TF32 off: one module per
architecture (``<arch>.py``, named by a configuration's ``arch``) and the
D-PSGD step they are driven through (``dpsgd.py``). They import nothing of
JAX, of the JAX package or of the program, and take only what the
benchmark hands the program: the parameters it made from the seed, W and
the tokens."""
