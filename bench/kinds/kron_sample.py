"""Keyed batch draws of a Kronecker DPP, one client in a closed loop.

Traffic parameters: ``batch`` (subsets a request), ``checked`` (requests
the check judges, drawn from the seed among the window's), ``limits``.

Set-up: the configuration's factors from the seed (``inputs.kron_factors``),
the port's ``dpp.Kron(factors).rescale(expected_size)``, and its spectrum
(cached by the port). Request i: ``model.sample(fold_in(PRNGKey(seed), i),
batch)``, then the picks, padded with -1, copied to host memory.

Check: the plain reference draws each judged request's uniforms from the
same keys (``reference.prng``), works out the spectrum and the rescale
from the seed's factors in float64, and judges every row of the request
(``reference.dpp.judge``).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .. import inputs
from ..harness import Check, Context
from ..reference import dpp as ref
from ..reference import prng as ref_prng
from ..roofline import phase2_select

#: Request indices of the warm-up, apart from the window's 0, 1, 2, ...
WARM_UP_BASE = 2 ** 31


class Workload:
    def __init__(self, ctx: Context):
        from repro_torch import dpp
        from repro_torch import random as prng
        self.ctx, self.prng = ctx, prng
        cfg, tr = ctx.config, ctx.traffic
        self.sizes = tuple(cfg["factor_sizes"])
        self.batch = int(tr["batch"])
        self.factors = inputs.kron_factors(ctx.seed, self.sizes, ctx.device)
        self.model = dpp.Kron(self.factors, device=ctx.device).rescale(
            float(cfg["expected_size"]))
        self.key = prng.PRNGKey(ctx.seed, ctx.device)

    def warm_up(self) -> None:
        for j in range(2):
            self.call(WARM_UP_BASE + j)

    def call(self, i: int) -> dict:
        key = self.prng.fold_in(self.key, i)
        draws = self.model.sample(key, self.batch, device=self.ctx.device)
        picks = torch.where(draws.mask, draws.indices.to(torch.int32), -1)
        with self.ctx.span("bench.copy_to_host"):
            picks = picks.cpu().numpy()
            truncated = draws.truncated.cpu().numpy()
        return {"i": i, "units": 1, "factor_sizes": self.sizes,
                "picks": picks, "truncated": truncated}

    def flops(self, rec: dict) -> float:
        """Phase 2's operations from the drawn sizes, and phase 1's one
        comparison a row and item."""
        N = int(np.prod(self.sizes))
        phase2 = phase2_select.of_record(rec)[0][0]
        return phase2 + float(len(rec["picks"])) * N

    def release(self) -> None:
        self.model = None

    def control(self, requests: int, precision: str):
        """The plain reference in the port's place, in float32 with its
        spectrum and every matrix product at ``precision``: ``requests``
        requests' records, as ``call`` gives them."""
        spec, _ = ref.rescaled(ref.spectrum(self.factors, torch.float32,
                                            precision),
                               float(self.ctx.config["expected_size"]))
        p = torch.sigmoid(spec.log_eigenvalues().double())
        k_max = int(np.ceil(float(p.sum()) + 6.0 * float(
            (p * (1 - p)).sum().sqrt()))) + 1
        out = []
        for i in range(requests):
            rows = ref_prng.split(ref_prng.fold_in(
                ref_prng.key(self.ctx.seed), i), self.batch)
            u, us = ref_prng.split_uniform(rows, spec.N, k_max)
            dev = self.ctx.device
            picks = ref.sample(spec, torch.from_numpy(u).to(dev),
                               torch.from_numpy(us).to(dev), k_max,
                               precision)
            out.append({"i": i, "units": 1, "factor_sizes": self.sizes,
                        "picks": picks.to(torch.int32).cpu().numpy(),
                        "truncated": np.zeros(self.batch, bool)})
        return out

    def check(self, kept: List[dict], last) -> List[Check]:
        dev = self.ctx.device
        spec, _ = ref.rescaled(ref.spectrum(self.factors),
                               float(self.ctx.config["expected_size"]))
        out = {"phase1_gap": 0.0, "phase2_gap": 0.0, "bad_rows": 0}
        for rec in kept:
            picks = torch.from_numpy(rec["picks"])
            rows = ref_prng.split(ref_prng.fold_in(
                ref_prng.key(self.ctx.seed), rec["i"]), self.batch)
            u, us = ref_prng.split_uniform(rows, spec.N, picks.shape[1])
            res = ref.judge(spec, torch.from_numpy(u).to(dev),
                            torch.from_numpy(us).to(dev), picks.to(dev),
                            torch.from_numpy(rec["truncated"]).to(dev))
            out["phase1_gap"] = max(out["phase1_gap"], res["phase1_gap"])
            out["phase2_gap"] = max(out["phase2_gap"], res["phase2_gap"])
            out["bad_rows"] += res["bad_rows"]
        lim = self.ctx.traffic["limits"]
        checks = [Check(k, float(v), float(lim[k])) for k, v in out.items()]
        checks.append(Check("unjudged", float(not kept), 0.0))
        return checks
