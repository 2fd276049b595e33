"""The phase-2 kernels' share (%) of their roofline: the least time that
the window's draws need (``roofline.phase2_select``, from each row's drawn
size) over the device time of every ``phase2_select_kernel*`` launch."""

from bench.roofline import phase2_select


def read(t):
    return t.roofline("phase2_select_kernel",
                      [w for r in t.records
                       for w in phase2_select.of_record(r)])
