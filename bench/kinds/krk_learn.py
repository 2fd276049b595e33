"""KrK-Picard learning of a Kronecker DPP (Mariet & Sra 2016, Alg. 1), back
to back through the window, one chunk of sweeps a call.

Traffic parameters: ``subsets`` (n, the observed subsets), ``chunk``
(sweeps a call; the log-likelihood is read once a chunk), ``step`` (the
constant step size a), ``checked`` (window calls the check judges, drawn
from the seed, besides the first and the last), ``limits``.

Set-up, all from the seed: the true kernel's factors rescaled to the
configuration's E|Y| (the reference's rescale); n subsets drawn from it by
the benchmark's own plain sampler (``reference.dpp.sample``, float64), so
that a change to the port's sampler cannot change the data; the start, a
second pair of factors rescaled alike. Then the first call, through the
window's own call: ``Kron(start).fit(data, algorithm="krk",
use_dense_theta=True, a=step, iters=chunk, log_every=chunk,
ll_mode="chunk")``. Each window call continues from the last one's
factors; its record keeps the factors it started from and those it
returned.

Check, for each judged call (the first, the seed's drawn ones and the
window's last): from the factors that call started from, the plain
reference (``reference.krk_picard``, float64) runs the call's sweeps; the
call's log-likelihood rise is compared with the reference's
(``ascent_gap``), and the norm of the kernel's change,
‖L1'⊗L2' - L1⊗L2‖, with the reference's (``kernel_change_gap``; not each
factor's: how a scale is split between the factors drifts apart in
float32 and float64 without changing L), each as a share of the
reference's. The log-likelihoods that the port reports are not
compared: their gap to float64 (5.5e-6 to 6.5e-6 of |LL|) has no reading
of the control three times as high to set a limit below.
"""

from __future__ import annotations

from typing import List

import torch

from .. import inputs
from ..harness import Check, Context
from ..reference import dpp as ref_dpp
from ..reference import krk_picard as ref
from ..reference import prng as ref_prng
from ..roofline import requests

#: fold_in data of the data's uniforms under the seed's key.
DATA_STREAM = 0x44415441


def _rescaled(factors, target: float):
    spec = ref_dpp.spectrum(factors)
    _, g = ref_dpp.rescaled(spec, target)
    gm = g ** (1.0 / len(factors))
    return tuple((f.double() * gm).float() for f in factors)


class Workload:
    def __init__(self, ctx: Context):
        from repro_torch import dpp
        from repro_torch.core.dpp import SubsetBatch
        self.ctx = ctx
        cfg, tr = ctx.config, ctx.traffic
        self.sizes = tuple(cfg["factor_sizes"])
        target = float(cfg["expected_size"])
        dev = ctx.device
        true = _rescaled(inputs.kron_factors(ctx.seed, self.sizes, dev),
                         target)
        spec = ref_dpp.spectrum(true)
        n = int(tr["subsets"])
        k_max = int(tr["k_max"])
        rows = ref_prng.split(ref_prng.fold_in(ref_prng.key(ctx.seed),
                                               DATA_STREAM), n)
        u, us = ref_prng.split_uniform(rows, spec.N, k_max)
        picks = ref_dpp.sample(spec, torch.from_numpy(u).to(dev),
                               torch.from_numpy(us).to(dev), k_max)
        self.mask = picks >= 0
        self.idx = torch.where(self.mask, picks, 0).to(torch.int32)
        self.data = SubsetBatch(self.idx, self.mask)
        self.start = _rescaled(inputs.kron_factors(
            ctx.seed, self.sizes, dev, tag=inputs.TAG_INIT), target)
        self.chunk = int(tr["chunk"])
        self.step = float(tr["step"])
        self.model = dpp.Kron(self.start, device=dev)
        self.factors = _kept(self.start)
        self.first = None
        self.subset_sizes = self.mask.sum(1).cpu().numpy()

    def _record(self, i: int, before, factors) -> dict:
        return {"i": i, "units": self.chunk, "sweeps": self.chunk,
                "factor_sizes": self.sizes, "before": before,
                "after": factors}

    def warm_up(self) -> None:
        self.first = self.call(-1)

    def call(self, i: int) -> dict:
        rep = self.model.fit(self.data, algorithm="krk",
                             use_dense_theta=True, a=self.step,
                             iters=self.chunk, log_every=self.chunk,
                             ll_mode="chunk", device=self.ctx.device)
        self.model = rep.model
        before, self.factors = self.factors, _kept(rep.model.factors)
        return self._record(i, before, self.factors)

    def flops(self, rec: dict) -> float:
        N1, N2 = self.sizes
        return (rec["sweeps"] * requests.krk_sweep(N1, N2, self.subset_sizes)
                + 2 * requests.krk_log_likelihood(N1, N2,
                                                  self.subset_sizes))

    def release(self) -> None:
        self.model = None

    def control(self, calls: int, precision: str) -> List[dict]:
        """The plain reference in the port's place, in float32 with every
        product, inverse and eigendecomposition at ``precision``: the first
        call and ``calls`` more, as ``call`` records them."""
        idx, mask = self.idx.long(), self.mask
        L = tuple(self.start)
        out = []
        for i in range(-1, calls):
            before = _kept(L)
            for _ in range(self.chunk):
                L = ref.sweep(*L, idx, mask, a=self.step,
                              precision=precision)
            out.append(self._record(i, before, _kept(L)))
        self.first = out[0]
        return out[1:]

    def check(self, kept: List[dict], last) -> List[Check]:
        lim = self.ctx.traffic["limits"]
        idx, mask = self.idx.long(), self.mask

        def ll(factors):
            return float(ref.log_likelihood(*factors, idx, mask))

        judged = {r["i"]: r for r in [self.first, *kept, last]
                  if r is not None}
        ascent = change = 0.0
        for rec in judged.values():
            L0, L1 = rec["before"], rec["after"]
            ll0, ll1 = ll(L0), ll(L1)
            L = L0
            for _ in range(rec["sweeps"]):
                L = ref.sweep(*L, idx, mask, a=self.step)
            # the call's rise and the kernel's change, against this
            # reference's own sweeps from the same factors
            rise = ll(L) - ll0
            ascent = max(ascent, abs((ll1 - ll0) - rise) / abs(rise))
            dr = ref.kron_change(L0, L)
            change = max(change, abs(ref.kron_change(L0, L1) - dr) / dr)
        return [Check("ascent_gap", ascent, float(lim["ascent_gap"])),
                Check("kernel_change_gap", change,
                      float(lim["kernel_change_gap"])),
                Check("calls_judged", float(2 - min(len(judged), 2)), 0.0)]


def _kept(factors):
    """The factors as the check reads them: float64 copies, on the device
    the program left them."""
    return tuple(f.detach().double() for f in factors)
