"""Evaluation traffic: whole link-prediction evaluations back to back.

Set-up builds the port's filter index (``build_kg_index(for_eval=True)``)
and the seeded tables, and runs two evaluations. Each unit of the window
is one ``eval/link_prediction.py::link_prediction`` over the whole test
split: both directions, raw and filtered, on the route the configuration
takes (B1 for TransE, chunks of ``eval_chunk``). Every evaluation the
window and the traced slice run is kept, and the comparison checks each
of them: every rank against the band the reference allows, and the
metrics reported from them."""

from __future__ import annotations

import hashlib
import importlib
from contextlib import ExitStack
from typing import Dict
from unittest import mock

import numpy as np

from kgbench.common import (KG_SEED, PROGRAM_SEED, TABLE_SEED, Run,
                            make_tables, program_config, program_dataset,
                            sync)
from kgbench.kg import kg_of
from kgbench.reference import ranks as ref
from kgbench.reference.train import tables_spec

WARM = 2


def summary(res) -> dict:
    """The ranks and metrics of a ``LinkPredictionResult``."""
    return {"ranks": {k: np.asarray(res.ranks[k]) for k in ref.KINDS},
            "metrics": {k: {m: getattr(getattr(res, k), m)
                            for m in ref.METRICS} for k in ref.KINDS}}


class Traffic:
    unit_name = "evaluations"

    def __init__(self, run: Run):
        self.run = run
        self.dev = run.device
        self.kept: Dict[str, list] = {}    # digest -> [summary, count]

    def prepare(self) -> None:
        from openkeonspark_tpu_torch.data.index import build_kg_index
        run, c = self.run, self.run.config
        self.kg = kg_of(c, run.sub_seed(KG_SEED))
        self.ds = program_dataset(self.kg)
        self.index = build_kg_index(self.ds, for_eval=True)
        self.cfg = program_config(c, run.sub_seed(PROGRAM_SEED) % (1 << 31))
        self.spec = tables_spec(c, self.kg.n_ent, self.kg.n_rel)
        self.params = make_tables(self.spec, run.sub_seed(TABLE_SEED),
                                  self.dev)
        self.lp = importlib.import_module(
            "openkeonspark_tpu_torch.eval.link_prediction")
        for _ in range(WARM):
            self._evaluate()
        sync(self.dev)

    def _evaluate(self):
        return self.lp.link_prediction(self.params, self.cfg, self.ds,
                                       self.index, triples=self.ds.test)

    def unit(self) -> None:
        s = summary(self._evaluate())
        h = hashlib.sha256()
        for k in ref.KINDS:
            h.update(s["ranks"][k].tobytes())
        h.update(repr(s["metrics"]).encode())
        self.kept.setdefault(h.hexdigest(), [s, 0])[1] += 1

    def e2e(self, seconds: float, units: int) -> Dict[str, float]:
        return {"eval_triples_per_s": units * len(self.kg.test) / seconds}

    def counts(self, units: int) -> Dict[str, int]:
        chunks = -(-len(self.kg.test) // self.cfg.eval_chunk)
        return {"evaluations": units, "chunks": units * 2 * chunks}

    def shapes(self) -> dict:
        return {"model": self.run.config["model"],
                "n_ent": self.kg.n_ent, "n_test": len(self.kg.test),
                "chunk": self.cfg.eval_chunk,
                "width": self.run.config["hidden_size"]}

    def free(self) -> None:
        del self.params, self.index

    def compare(self) -> Dict[str, float]:
        E = make_tables(self.spec, self.run.sub_seed(TABLE_SEED), self.dev)
        known = ref.Known(self.kg.all_triples(), self.kg.n_ent,
                          self.kg.n_rel)
        band = ref.bands(E["ent_embeddings"], E["rel_embeddings"],
                         self.kg.test, known)
        results = list(self.kept.values())
        if self.run.control:
            r = ref.lower_precision_ranks(E["ent_embeddings"],
                                          E["rel_embeddings"], self.kg.test,
                                          known)
            results = [[{"ranks": r, "metrics": {
                k: ref.metrics(r[k]) for k in ref.KINDS}}, 1]]
        outside = sum(ref.outside(s, band) * n for s, n in results)
        if not results:
            outside = float("inf")
        return {"ranks_outside": float(outside)}


# ---------------------------------------------------------------------------
# faults planted under the timed path (the tests only)


def _patch_chunks(stack: ExitStack, alter) -> None:
    lp = importlib.import_module(
        "openkeonspark_tpu_torch.eval.link_prediction")
    orig = lp._chunked_link_prediction

    def wrapped(cfg, triples, *a, **kw):
        return alter(orig, cfg, triples, *a, **kw)
    stack.enter_context(mock.patch.object(lp, "_chunked_link_prediction",
                                          wrapped))


def _answer(run: Run, stack: ExitStack) -> None:
    """One triple's filtered tail rank is altered where it is counted."""
    def alter(orig, cfg, triples, *a, **kw):
        ranks = orig(cfg, triples, *a, **kw)
        ranks["filt_tail"][0] += max(1, run.config["n_ent"] // 4)
        return ranks
    _patch_chunks(stack, alter)


def _half(run: Run, stack: ExitStack) -> None:
    """Half of the test triples are ranked; the rest repeat their
    ranks."""
    def alter(orig, cfg, triples, *a, **kw):
        n = len(triples)
        part = orig(cfg, triples[:(n + 1) // 2], *a, **kw)
        return {k: np.resize(v, n) for k, v in part.items()}
    _patch_chunks(stack, alter)


FAULTS = {"answer": _answer, "half_batch": _half}
