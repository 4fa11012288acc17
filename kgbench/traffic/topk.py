"""Query traffic: top-k entity queries in a closed loop, one client.

Each query is ``eval/predict.py::predict_tail_entity`` (h, r, ?) or
``predict_head_entity`` (?, r, t), the direction drawn from the seed with
probability ``head_share``, its anchor and relation those of a test
triple drawn from the seed, so entity popularity follows the KG's Zipf
skew. A query is timed from its call until its ids and scores are on the
host, and the next is sent when it returns. Set-up draws the query list
(``queries`` long; the window cycles through it), builds the seeded
tables and answers ``warm`` queries. Every answer of the window and the
traced slice is kept and judged against the reference's exact scores."""

from __future__ import annotations

import importlib
import time
from contextlib import ExitStack
from typing import Dict
from unittest import mock

import numpy as np

from kgbench.common import (KG_SEED, PROGRAM_SEED, QUERY_SEED, TABLE_SEED,
                            Run, make_tables, program_config, sync)
from kgbench.kg import kg_of
from kgbench.reference import topk as ref
from kgbench.reference.train import tables_spec


class Traffic:
    unit_name = "queries"

    def __init__(self, run: Run):
        self.run = run
        self.dev = run.device
        self.k = run.mix["k"]
        self.latency = []
        self.answers = []      # (query index, ids, scores)
        self.i = 0

    def prepare(self) -> None:
        run, c, mix = self.run, self.run.config, self.run.mix
        self.kg = kg_of(c, run.sub_seed(KG_SEED))
        self.cfg = program_config(c, run.sub_seed(PROGRAM_SEED) % (1 << 31))
        self.spec = tables_spec(c, self.kg.n_ent, self.kg.n_rel)
        self.params = make_tables(self.spec, run.sub_seed(TABLE_SEED),
                                  self.dev)
        rng = np.random.default_rng(run.sub_seed(QUERY_SEED))
        rows = self.kg.test[rng.integers(0, len(self.kg.test),
                                         mix["queries"])].astype(np.int64)
        head = rng.random(mix["queries"]) < mix["head_share"]
        # (0 tail / 1 head, anchor, relation)
        self.queries = np.stack([head.astype(np.int64),
                                 np.where(head, rows[:, 1], rows[:, 0]),
                                 rows[:, 2]], 1)
        self.predict = importlib.import_module(
            "openkeonspark_tpu_torch.eval.predict")
        for _ in range(mix["warm"]):
            self._ask(self.queries[self.i % len(self.queries)])
            self.i += 1
        sync(self.dev)
        self.i = 0

    def _ask(self, q):
        fn = self.predict.predict_head_entity if q[0] else \
            self.predict.predict_tail_entity
        return fn(self.params, self.cfg, self.kg.n_ent, self.kg.n_rel,
                  int(q[1]), int(q[2]), k=self.k)

    def unit(self) -> None:
        qi = self.i % len(self.queries)
        t0 = time.perf_counter()
        ids, scores = self._ask(self.queries[qi])
        self.latency.append(time.perf_counter() - t0)
        self.answers.append((qi, ids, scores))
        self.i += 1

    def e2e(self, seconds: float, units: int) -> Dict[str, float]:
        lat = np.asarray(self.latency[:units]) * 1e3
        return {"topk_p95_ms": float(np.percentile(lat, 95))}

    def counts(self, units: int) -> Dict[str, int]:
        return {"queries": units}

    def shapes(self) -> dict:
        return {"model": self.run.config["model"], "n_ent": self.kg.n_ent,
                "k": self.k, "width": self.run.config["hidden_size"]}

    def free(self) -> None:
        del self.params

    def compare(self) -> Dict[str, float]:
        E = make_tables(self.spec, self.run.sub_seed(TABLE_SEED), self.dev)
        idx = np.asarray([a[0] for a in self.answers], np.int64)
        queries = self.queries[idx]
        answers = [(a[1], a[2]) for a in self.answers]
        if self.run.control:
            answers = ref.lower_precision_answers(
                E["ent_embeddings"], E["rel_embeddings"], queries, self.k,
                self.kg.n_ent)
        bad = ref.violations(E["ent_embeddings"], E["rel_embeddings"],
                             queries, answers, self.k, self.kg.n_ent)
        return {"topk_outside": float(bad.sum()) if len(bad)
                else float("inf")}


# ---------------------------------------------------------------------------
# faults planted under the timed path (the tests only)


def _wrap_predict(stack: ExitStack, alter) -> None:
    predict = importlib.import_module(
        "openkeonspark_tpu_torch.eval.predict")
    for name in ("predict_tail_entity", "predict_head_entity"):
        orig = getattr(predict, name)
        stack.enter_context(mock.patch.object(
            predict, name,
            lambda params, cfg, n_ent, n_rel, a, r, k=10, _o=orig:
            alter(_o, params, cfg, n_ent, n_rel, a, r, k)))


def _answer(run: Run, stack: ExitStack) -> None:
    """The best id of every answer is altered where it is produced."""
    def alter(orig, params, cfg, n_ent, n_rel, a, r, k):
        ids, scores = orig(params, cfg, n_ent, n_rel, a, r, k)
        ids = ids.copy()
        ids[0] = (ids[0] + 1) % n_ent
        return ids, scores
    _wrap_predict(stack, alter)


def _half(run: Run, stack: ExitStack) -> None:
    """Half of the candidate entities are left out of every query."""
    def alter(orig, params, cfg, n_ent, n_rel, a, r, k):
        return orig(params, cfg, n_ent // 2, n_rel, a, r, k)
    _wrap_predict(stack, alter)


FAULTS = {"answer": _answer, "half_batch": _half}
