"""setup_s: seconds from the process's start to the window's start: imports,
CUDA initialisation, the kernels' libraries (built in the checkout's
``build/`` by the first run), the templates, the reference's payloads and
one warm call at the cell's shapes."""


def read(run):
    return run.setup_s
