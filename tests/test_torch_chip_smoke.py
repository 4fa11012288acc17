"""Guards of ``chip_smoke.py``'s tables on the CPU: the variant builds'
text replacements, the id scorers it names for ptxas and SASS, and the
variants it times. A stale entry would otherwise fail only on the card,
after the kernel library's build."""

import importlib.util
import os
import re

import pytest

from openkeonspark_tpu_torch.ops import rank
from openkeonspark_tpu_torch.ops.build import CSRC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CS = _chip_smoke()


@pytest.mark.parametrize("name", sorted(CS.VARIANT_BUILDS))
def test_variant_replacements_occur_once(name):
    """Each (old, new) of a variant build occurs exactly once in its source
    or header under ops/csrc/, as start_variant_build requires, and the
    replaced text differs."""
    source, replacements, *header = CS.VARIANT_BUILDS[name]
    edits = [(source, replacements)] + list(header)
    assert any(pairs for _, pairs in edits), name
    for fname, pairs in edits:
        text = (CSRC / fname).read_text()
        for old, new in pairs:
            assert text.count(old) == 1, (fname, old)
            assert old != new


def _ids_terms():
    """{Term name: source} of every Term launched through rank_ids.cuh's
    id_scorer::score_ids."""
    terms = {}
    for path in CSRC.glob("*.cu"):
        for term in re.findall(r"id_scorer::score_ids<(\w+)<",
                               path.read_text()):
            terms[term] = path.name
    return terms


def test_id_scorers_name_every_term():
    """ID_SCORERS names, for every rank model, the Term its id scorer
    launches on rank_ids.cuh, and no Term that none launches."""
    terms = _ids_terms()
    assert set(terms) == {"TransEIds", "TransDIds", "TransHIds", "RotateIds"}
    named = {}
    for model, (kernel, part) in CS.ID_SCORERS.items():
        assert kernel == "score_ids_kernel"
        # the mangled Term: its name, then I<template arguments>E
        named[model] = re.match(r"([A-Za-z]+?Ids)I", part).group(1)
    assert set(named) == set(rank.KERNELS)
    assert set(named.values()) == set(terms)
    for model, term in named.items():
        source = CS.KERNELS[f"{model}_candidate_scores"][0]
        assert source == CS.IDS, model
        # the Term lives beside the model's count
        count_source = CS.KERNELS[f"count_better_{model}"][0]
        assert os.path.basename(count_source) == terms[term], model


@pytest.mark.parametrize("table", ["ID_VARIANTS", "B6_VARIANTS"])
def test_timed_variants_are_built(table):
    """Every variant chip_smoke times is a key of VARIANT_BUILDS, and every
    variant build is timed somewhere."""
    timed = getattr(CS, table)
    names = [n for v in timed.values() for n in v] if table == "ID_VARIANTS" \
        else list(timed)
    assert names
    assert set(names) <= set(CS.VARIANT_BUILDS)
    if table == "ID_VARIANTS":
        assert set(timed) <= set(CS.ID_SCORERS)
        for model, variants in timed.items():
            for name in variants:
                source = CS.VARIANT_BUILDS[name][0]
                assert source == CS.KERNELS[f"count_better_{model}"][0] \
                    .rsplit("/", 1)[1], (model, name)
