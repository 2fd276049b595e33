"""Process start to the first timed request (host clock): imports, inputs,
the port's set-up, kernel builds and the warm-up."""


def read(w):
    return w.setup_s
