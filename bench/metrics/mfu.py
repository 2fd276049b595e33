"""The traced window's algorithmic FLOPs, of its requests or sweeps
(``roofline.requests``, counted by the cell's kind), over the window's time
at the card's peak in the configuration's precision (%)."""


def read(t):
    return t.mfu()
