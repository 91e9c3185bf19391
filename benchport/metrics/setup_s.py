"""setup_s: seconds from the process's start to the window's start: imports
and device initialisation, the kernel library's load (its build on a first
run), the inputs, the engines' constants and the warm-up on every stream."""


def read(r):
    return r.setup_s
