# Hand-written Hopper kernels (csrc/*.cu, built with nvcc at first use by
# build.py) with their ctypes wrappers, the plain PyTorch versions they are
# held against (ref.py), and the device-dispatching public ops (ops.py).
