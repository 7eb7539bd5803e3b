"""setup_s: seconds from the process's start to the window's start
(imports, card start-up, inputs and weights, the kernel library, warm-up)."""


def read(r):
    return r.setup_s
