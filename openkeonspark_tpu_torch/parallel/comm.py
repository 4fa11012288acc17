"""Communication-volume accounting: the collective payload bytes a step
issues, counted where it issues them, and the analytic scaling model over
H100 links.

Counterpart of ``openkeonspark_tpu/parallel/comm.py``. The JAX package
parses the compiled HLO of a step for its collectives; the port's steps
are eager, and every collective they issue runs through the three
functions of ``parallel/mesh.py`` (``all_reduce``, ``all_gather``,
``all_to_all``), which hand their bytes to an active recorder. So:

- :class:`CollectiveCounter` records, while on, each collective's kind,
  payload (the op's output bytes, the JAX convention of ``:126-141``: an
  ``all_gather`` n × its input, an ``all_reduce`` or ``all_to_all`` its
  tensor) and replica groups (``Grid.members``), and turns them into the
  JAX function's dict (:func:`bytes_of`): per-kind payload, ``total``,
  per-device ``wire`` bytes with the ring factors of ``:142-155``, and
  with ``chips_per_host`` their split between links inside a host
  (``wire_ici``; on H100s NVLink) and links across hosts (``wire_dcn``;
  the network), the key names kept for parity. Hosts are blocks of
  ``chips_per_host`` consecutive ranks: the grid is host-major
  (``mesh.py``), as JAX's device order is.
- :func:`collective_bytes` runs a step once under the counter.
- :func:`wire_bytes_estimate` and :func:`predict_scaling` are the JAX
  model (``:247-367``) with the links as arguments whose defaults are
  sourced H100 figures; no TPU figure remains.

Two things of the JAX module have no counterpart here, since an eager
program has no compiled module to read: the HLO text handling
(``_split_computations``, ``_parse_groups``, the tuple-shape and comment
workarounds of ``hlo_collective_bytes``), whose work the recorder does at
the call, and the def-use graph of ``tools/overlap_report.py``'s
dependent and independent collective pairs.

The exact overflow fallbacks: the JAX count skips ``lax.cond`` branches
(``:87-91``), so its figures are the steady state. The port decides a
fallback on the host (``exchange.py``, ``step.fallbacks``) and its steps
mark a fallback's collectives (``mesh.fallback``): the counter keeps their
bytes under ``"fallback"``, out of the steady-state figures. One rule
differs by design: a collective over a one-rank axis returns before it
records (``mesh.py``), where the JAX module counts the payload of an op
over one-device groups (its wire is 0 in both).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch.distributed as dist

from openkeonspark_tpu_torch.parallel import mesh

KINDS = ("all-reduce", "all-gather", "all-to-all", "reduce-scatter",
         "collective-permute")

Groups = Tuple[Tuple[int, ...], ...]


def _wire(kind: str, payload: int, g: int) -> float:
    """Per-device wire bytes of one op over groups of ``g`` ranks, the ring
    factors of the JAX count (``comm.py:142-155``)."""
    f = (g - 1) / g
    if kind == "all-reduce":
        return 2 * f * payload
    if kind == "reduce-scatter":
        return (g - 1) * payload
    if kind == "collective-permute":
        return payload
    return f * payload   # all-gather / all-to-all: payload = full output


def dcn_share(kind: str, payload: int, groups: Groups,
              chips_per_host: int) -> float:
    """Per-device wire bytes of one collective that cross a host boundary,
    averaged over every member of every group (``_dcn_share``,
    ``comm.py:197-244``, the same per-kind model): an ``all_to_all``
    sends payload · remote / G off-host, exactly the blocks addressed to
    ranks on other hosts; an ``all_gather`` and an ``all_reduce`` cross
    hosts once per host (payload · (H_g − 1) / H_g, twice that for the
    reduction), divided over the host's members; a reduce-scatter after
    an in-host pre-reduction payload · (H_g − 1); a permute fully."""
    total, members = 0.0, 0
    for grp in groups:
        gsz = len(grp)
        if gsz <= 1:
            continue
        blocks = [m // chips_per_host for m in grp]
        nb = len(set(blocks))
        for b in blocks:
            same = blocks.count(b)
            remote = gsz - same
            if remote == 0:
                d = 0.0
            elif kind == "all-to-all":
                d = payload * remote / gsz
            elif kind == "all-gather":
                d = payload * (nb - 1) / nb / same
            elif kind == "all-reduce":
                d = 2.0 * payload * (nb - 1) / nb / same
            elif kind == "reduce-scatter":
                d = payload * (nb - 1)
            else:
                d = float(payload)
            total += d
            members += 1
    return total / members if members else 0.0


def bytes_of(events, chips_per_host: int = 0) -> Dict:
    """The JAX ``collective_bytes`` dict of recorded events ``(kind,
    payload, groups, in_fallback)``: per-kind payload, ``total``,
    ``wire``, and with ``chips_per_host`` > 0 ``wire_ici``, ``wire_dcn``
    and ``chips_per_host``; ``fallback``, the per-kind payload and
    ``total`` of the exact fallbacks' collectives, which the other keys
    leave out."""
    out = {k: 0 for k in KINDS}
    fb = {k: 0 for k in KINDS}
    wire = dcn = 0.0
    for kind, payload, groups, in_fallback in events:
        if in_fallback:
            fb[kind] += payload
            continue
        out[kind] += payload
        g = len(groups[0])
        if g > 1:
            w = _wire(kind, payload, g)
            wire += w
            if chips_per_host:
                dcn += min(w, dcn_share(kind, payload, groups,
                                        chips_per_host))
    out["total"] = sum(out[k] for k in KINDS)
    out["wire"] = int(wire)
    if chips_per_host:
        out["wire_dcn"] = int(dcn)
        out["wire_ici"] = int(wire - dcn)
        out["chips_per_host"] = chips_per_host
    fb["total"] = sum(fb[k] for k in KINDS)
    out["fallback"] = fb
    return out


class CollectiveCounter:
    """Records, while on (``with``), every collective of ``parallel/mesh.py``
    this process issues; ``counter.bytes`` is then their :func:`bytes_of`
    dict, ``counter.count`` the number of collectives issued outside the
    exact fallbacks and ``counter.fallback_count`` inside them.

    On leaving, with a process group of more than one rank, the counter
    compares its dict with every rank's through one ``all_gather`` (made
    after recording stops, so it counts nothing) and raises if they
    differ: a step's collectives are the same on every rank, and so are
    its bytes. Counters nest; the inner one records alone."""

    def __init__(self, chips_per_host: int = 0):
        self.chips_per_host = chips_per_host
        self.events = []
        self.in_fallback = 0
        self.bytes: Optional[Dict] = None
        self._outer = None

    def record(self, kind: str, payload: int, grid, axis: str) -> None:
        self.events.append((kind, payload, grid.members(axis),
                            self.in_fallback > 0))

    @property
    def count(self) -> int:
        return sum(not e[3] for e in self.events)

    @property
    def fallback_count(self) -> int:
        return len(self.events) - self.count

    def __enter__(self):
        self._outer, mesh.recorder = mesh.recorder, self
        return self

    def __exit__(self, exc_type, *exc):
        mesh.recorder = self._outer
        self.bytes = bytes_of(self.events, self.chips_per_host)
        if exc_type is None and dist.is_initialized() \
                and dist.get_world_size() > 1:
            mine = (self.bytes, self.count, self.fallback_count)
            every = [None] * dist.get_world_size()
            dist.all_gather_object(every, mine)
            bad = [r for r, x in enumerate(every) if x != mine]
            if bad:
                raise RuntimeError(
                    f"rank {dist.get_rank()} counted {mine}, rank {bad[0]} "
                    f"{every[bad[0]]}: the ranks' collectives differ")
        return False


def collective_bytes(fn: Callable, *args, chips_per_host: int = 0,
                     **kw) -> Dict:
    """Per-device collective payload bytes of one call of ``fn(*args,
    **kw)``, as a :class:`CollectiveCounter` dict (the JAX function's
    keys, ``comm.py:247-265``, and ``fallback``).

    Unlike the JAX function, which lowers ``fn`` and reads its program,
    this one RUNS it once: every rank of the grid must call it, and a
    step that updates its tables in place updates them, so pass a copy of
    a state that must stay as it was."""
    with CollectiveCounter(chips_per_host) as counter:
        fn(*args, **kw)
    return counter.bytes


def wire_bytes_estimate(payload: Dict[str, int], n_devices: int) -> int:
    """Per-device on-wire bytes: the counter's per-op ``wire`` figure, or
    the ring factors at the mesh size for a dict without it
    (``comm.py:268-281``)."""
    if "wire" in payload:
        return payload["wire"]
    n = max(2, n_devices)
    f = (n - 1) / n
    return int(payload.get("all-reduce", 0) * 2 * f
               + payload.get("all-gather", 0) * f
               + payload.get("reduce-scatter", 0) * f
               + payload.get("all-to-all", 0) * f
               + payload.get("collective-permute", 0))


# Per-GPU link bandwidths (bytes/s, one direction). Each nominal figure is
# at most half its line rate, so that BW_BRACKETS' optimistic ×2 never
# exceeds the line rate (the pessimistic ×0.5 is a quarter of it). Sources:
# - NVLink (inside a node): NVIDIA's H100 Tensor Core GPU datasheet gives
#   the H100 SXM5 fourth-generation NVLink at 900 GB/s per GPU,
#   bidirectional: 450 GB/s one way (line rate), nominal half of it.
# - Network (across nodes): the DGX H100 / HGX H100 system documentation
#   gives one 400 Gb/s ConnectX-7 NIC (InfiniBand NDR) per GPU, 8 a node:
#   50 GB/s one way (line rate). The nominal figure is half of what
#   carries payload: a 4,096-byte MTU packet also carries 26 bytes of
#   InfiniBand headers and CRCs (LRH 8, BTH 12, ICRC 4, VCRC 2).
NVLINK_LINE_BW = 450e9
NET_LINE_BW = 50e9
NVLINK_BW = NVLINK_LINE_BW / 2
NET_BW = NET_LINE_BW * 4096 / (4096 + 26) / 2
GPUS_PER_HOST = 8      # GPUs a DGX / HGX H100 node joins over NVLink
GPUS_PER_NIC = 1       # GPUs sharing one network NIC on such a node
BW_BRACKETS = (0.5, 1.0, 2.0)   # pessimistic / nominal / optimistic
OVERLAP_BRACKETS = (0.0, 0.9, 1.0)


def predict_scaling(single_chip_step_s: float,
                    comm_payload_by_mesh: Dict[tuple, Dict[str, int]],
                    gpus_per_host: int = GPUS_PER_HOST,
                    bw_scale: float = 1.0, overlap: float = 0.0,
                    link_model: str = "pipelined",
                    nvlink_bw: float = NVLINK_BW, net_bw: float = NET_BW,
                    gpus_per_nic: int = GPUS_PER_NIC) -> Dict[tuple, dict]:
    """Analytic scaling table, the JAX model (``comm.py:304-367``) over
    H100 links. A mesh step's time = max(compute, comm) + (1 −
    overlap)·min(compute, comm), compute = the measured single-device
    step time (weak scaling: the per-device batch constant); efficiency =
    compute / step.

    With the ``wire_ici`` / ``wire_dcn`` split (``collective_bytes(...,
    chips_per_host=L)``): ``t_nvlink = wire_ici / nvlink_bw`` and ``t_net
    = min(gpus_per_nic, n)·wire_dcn / net_bw``, a NIC carrying the bytes
    of the GPUs that share it (the JAX model shares one host NIC among
    the host's L chips; an H100 node has a NIC a GPU). ``'pipelined'``
    takes comm = max(t_nvlink, t_net), ``'serial'`` their sum. A dict
    without the split charges every wire byte at NVLink inside
    ``gpus_per_host`` devices and at the network beyond.

    ``overlap`` is the share of the shorter of compute and comm hidden
    under the longer. It defaults to 0: the port's step is eager, each
    collective issued in program order, and the steps read their
    overflow counts on the host between collectives, so nothing overlaps
    a collective with compute (the JAX default, 0.9, rested on XLA's
    latency-hiding scheduler). ``OVERLAP_BRACKETS`` and ``BW_BRACKETS``
    (a factor on both bandwidths, ``bw_scale``) bracket the model. Every
    figure out of it is a prediction from these constants, none a
    measurement of a link."""
    out = {}
    for mesh_shape, payload in comm_payload_by_mesh.items():
        n = 1
        for s in mesh_shape:
            n *= s
        compute = single_chip_step_s
        wire = wire_bytes_estimate(payload, n)
        if "wire_dcn" in payload:
            t_nvlink = payload["wire_ici"] / (nvlink_bw * bw_scale)
            t_net = (payload["wire_dcn"] * min(gpus_per_nic, n)
                     / (net_bw * bw_scale))
            comm = (t_nvlink + t_net if link_model == "serial"
                    else max(t_nvlink, t_net))
            link = "NVLink" if payload["wire_dcn"] == 0 else \
                "NVLink+network"
        else:
            bw = (nvlink_bw if n <= gpus_per_host else net_bw) * bw_scale
            comm = wire / bw
            link = "NVLink" if n <= gpus_per_host else "network"
        step = max(compute, comm) + min(compute, comm) * (1.0 - overlap)
        out[mesh_shape] = {
            "devices": n,
            "wire_bytes_per_device": wire,
            "wire_dcn_per_device": payload.get("wire_dcn"),
            "comm_s": comm,
            "predicted_step_s": step,
            "scaling_efficiency": compute / step,
            "link": link,
        }
    return out
