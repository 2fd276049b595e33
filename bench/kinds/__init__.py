"""The request kinds a traffic mix names (its ``kind``). Each module has a
``Workload(ctx)`` with ``warm_up()``, ``call(i)`` (one request or chunk,
its result in host memory, returned as a record), ``flops(record)`` (the
algorithmic FLOPs of the record's request, ``roofline.requests``),
``release()`` (the port's state freed) and ``check(kept, last)`` (the
comparison with the plain reference).

A record holds ``units`` (requests or sweeps) and the facts of its work
that ``roofline/<kernel>.of_record`` reads: ``factor_sizes`` with
``picks`` (B, k_max), a batch of draws from a Kronecker kernel;
``map_size`` with ``picks`` (k,), a greedy MAP over that many items;
``factor_sizes`` with ``sweeps``, KrK-Picard sweeps.
"""
