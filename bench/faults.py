"""Faults planted in the port, for the checks' tests and for the readings
that set a limit (``control.py --fault``): each turns one call of the
timed path into a wrong one of the kind a broken change would make. The
benchmark's runs never plant one.

Each entry: cell kind -> fault name -> (module, attribute, wrapper), the
wrapper taking the original callable and returning the broken one.
"""

import importlib

import torch


def _altered_pick(fn):
    def broken(us, Gs, sizes, k_eff, backend=None):
        picks = fn(us, Gs, sizes, k_eff, backend=backend).clone()
        N = 1
        for s in sizes:
            N *= int(s)
        picks[0, 0] = (picks[0, 0] + N // 2) % N
        return picks
    return broken


def _half_the_rows(fn):
    def broken(us, Gs, sizes, k_eff, backend=None):
        h = us.shape[0] // 2
        picks = fn(us[:h], tuple(G[:h] for G in Gs), sizes, k_eff[:h],
                   backend=backend)
        return torch.cat([picks, picks])[:us.shape[0]]
    return broken


def _altered_map(fn):
    def broken(L, k, backend=None):
        picks = fn(L, k, backend=backend).clone()
        taken = set(picks.tolist())
        picks[1] = next(j for j in range(L.shape[-1]) if j not in taken)
        return picks
    return broken


def _half_the_probe(fn):
    def broken(gate, up):
        out = fn(gate, up).clone()
        out[out.shape[0] // 2:] = 0.0
        return out
    return broken


def _unchanged_state(fn):
    def broken(params, data, a_trial, schedule, stats, fresh_theta=True):
        return tuple(params), a_trial, 0
    return broken


def _half_the_subsets(fn):
    def broken(params, data, a_trial, schedule, stats, fresh_theta=True):
        from repro_torch.core.dpp import SubsetBatch
        h = data.indices.shape[0] // 2
        half = SubsetBatch(data.indices[:h], data.mask[:h])
        return fn(params, half, a_trial, schedule, stats, fresh_theta)
    return broken


def _unchanged_after_first_call(engine_cls):
    class Stale(engine_cls):
        """The learning engine whose sweeps return their state unchanged
        once a first fit has run: the set-up's call is sound, every call
        of the window is not."""
        fits = 0

        def run(self, *args, **kwargs):
            Stale.fits += 1
            return super().run(*args, **kwargs)

        def _krk_sweep(self, params, sub, a_trial):
            if Stale.fits > 1:
                return tuple(params), a_trial, 0
            return super()._krk_sweep(params, sub, a_trial)
    return Stale


FAULTS = {
    "kron_sample": {
        "altered_answer": ("repro_torch.kernels.ops", "phase2_select",
                           _altered_pick),
        "half_the_batch": ("repro_torch.kernels.ops", "phase2_select",
                           _half_the_rows)},
    "ffn_prune": {
        "altered_answer": ("repro_torch.kernels.ops", "greedy_map_kdpp",
                           _altered_map),
        "half_the_batch": ("repro_torch.models.common", "swiglu",
                           _half_the_probe)},
    "krk_learn": {
        "unchanged_state": ("repro_torch.learning.engine", "krk_sweep",
                            _unchanged_state),
        "unchanged_after_first_call": ("repro_torch.learning.api",
                                       "LearningEngine",
                                       _unchanged_after_first_call),
        "half_the_batch": ("repro_torch.learning.engine", "krk_sweep",
                           _half_the_subsets)},
}


def plant(kind: str, fault: str):
    """Plant ``fault`` of ``kind``'s cells; returns a function that takes
    it out again."""
    target, attr, wrap = FAULTS[kind][fault]
    mod = importlib.import_module(target)
    original = getattr(mod, attr)
    setattr(mod, attr, wrap(original))
    return lambda: setattr(mod, attr, original)
