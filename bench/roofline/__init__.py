"""Operations and bytes of the port's kernels and of whole requests,
counted from shapes and the drawn sizes, whatever implements them.

Each byte of a kernel's inputs is counted once read and each byte of its
output once written; where the work depends on the data, what these inputs
need is counted, not the most they could. Each kernel's module has
``work(...)`` from shapes, and ``of_record(record)``: the work that one
record of a window (``kinds/__init__.py`` names its fields) needs of that
kernel, empty where it needs none. ``peaks.json`` holds the card's
published peaks.
"""
