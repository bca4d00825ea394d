"""The plain float32 reference of the benchmark's configurations: plain
PyTorch, independent of the program (it imports nothing of the port or
of the JAX package), with TF32 off. ``correct`` holds the program's
answers against it (``perfbench/check.py``); ``precision.py`` gives the
lower-precision control.
"""
