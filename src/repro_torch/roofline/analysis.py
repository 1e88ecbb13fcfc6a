"""Three-term roofline for one rank's step on the H100: the port's ``repro.roofline.analysis``.

The terms are derived, not measured: counts from a traced step
(``roofline.trace.StepCounter``) over the peak rates of an H100 SXM (the
card the port runs on, ``NVIDIA H100 80GB HBM3``; the reference's are a TPU
v5e's)::

    compute term    = sum over product classes of flops / that class's peak
    memory term     = HBM bytes / 3.35 TB/s
    collective term = sum over exchanges of wire bytes / the slowest link
                      the exchange's group crosses

Peaks (``PEAK_FLOPS``, dense, no sparsity): bf16 989 TFLOP/s on the tensor
cores; f32 67 TFLOP/s on the CUDA cores (the port runs f32 products with
TF32 off, so an f32 product is charged here, not at a TF32 rate); split TF32
165 TFLOP/s (three TF32 products a product, the flash kernels' f32 route).
One peak for every product, as the reference's single bf16 rate, would
misstate an f32 step by 15x.  Links: NVLink 450 GB/s a direction between
the 8 GPUs of a node; the network 50 GB/s a GPU (one 400 Gb/s NIC) between
nodes.  In row-major rank order a group within 8 consecutive ranks
(``rank // 8`` equal) stays on NVLink; any other crosses the network.
``HW["device_memory"]`` is the card's memory as
``torch.cuda.get_device_properties(0).total_memory`` reports it on the H100
machine (``chip_smoke.py``'s ``dryrun`` phase prints it).

``model_flops`` is the reference's, copied (no JAX import).
"""
from __future__ import annotations

import dataclasses

__all__ = ["HW", "PEAK_FLOPS", "RooflineTerms", "collective_bytes", "roofline_terms",
           "model_flops", "wire_bytes", "link_of"]

HBM_BW = 3.35e12
NVLINK_BW = 450e9
NETWORK_BW = 50e9
GPUS_PER_NODE = 8
# bytes: torch.cuda.get_device_properties(0).total_memory on the H100 machine
# (NVIDIA H100 80GB HBM3, torch 2.11.0+cu128)
DEVICE_MEMORY = 85_017_493_504
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "split_tf32": 165e12}

HW = {"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW, "nvlink_bw": NVLINK_BW,
      "network_bw": NETWORK_BW, "gpus_per_node": GPUS_PER_NODE,
      "device_memory": DEVICE_MEMORY}
LINK_BW = {"nvlink": NVLINK_BW, "network": NETWORK_BW}

def wire_bytes(kind: str, size: float, g: int) -> float:
    """Bytes a rank puts on the wire for one exchange of ``kind`` over a
    group of ``g`` ranks, by the ring algorithm's costs (the reference's
    ``roofline/hlo.py``): all-gather ``(g-1)/g`` of its result,
    reduce-scatter ``(g-1)`` times its result, all-reduce ``2 (g-1)/g`` of
    its size, all-to-all ``(g-1)/g``, a permute (a send) its size; a
    broadcast its size."""
    if kind == "all-gather":
        return size * (g - 1) / max(g, 1)
    if kind == "reduce-scatter":
        return size * (g - 1)
    if kind == "all-reduce":
        return 2.0 * size * (g - 1) / max(g, 1)
    if kind == "all-to-all":
        return size * (g - 1) / max(g, 1)
    if kind in ("collective-permute", "broadcast"):
        return float(size)
    raise ValueError(f"unknown collective kind {kind!r}")


def link_of(ranks) -> str:
    """The slowest link a group of global ranks crosses."""
    nodes = {int(r) // GPUS_PER_NODE for r in ranks}
    return "nvlink" if len(nodes) <= 1 else "network"


def collective_bytes(collectives) -> dict:
    """Per-rank wire bytes of exchanges given as ``(kind, size_bytes, g)`` or
    ``(kind, size_bytes, g, link)``: ``{"total_bytes", "per_kind",
    "num_ops"}`` (and ``"per_link"``), the reference's record."""
    per_kind: dict = {}
    per_link: dict = {}
    n = 0
    for item in collectives:
        kind, size, g = item[:3]
        link = item[3] if len(item) > 3 else "nvlink"
        w = wire_bytes(kind, size, g)
        per_kind[kind] = per_kind.get(kind, 0.0) + w
        per_link[link] = per_link.get(link, 0.0) + w
        n += 1
    return {"total_bytes": float(sum(per_kind.values())), "per_kind": per_kind,
            "per_link": per_link, "num_ops": n}


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collective_ops: int
    per_kind: dict
    flops_by_class: dict = dataclasses.field(default_factory=dict)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    def as_dict(self):
        d = dataclasses.asdict(self)
        d["dominant"] = self.dominant
        return d


def roofline_terms(counts) -> RooflineTerms:
    """The three terms from a traced step's counts (``StepCounter``):
    ``flops`` by class, ``hbm_bytes`` and ``collectives``."""
    unknown = set(counts.flops) - set(PEAK_FLOPS)
    if unknown:
        raise ValueError(f"no peak for product classes {sorted(unknown)}")
    cb = collective_bytes(counts.collectives)
    return RooflineTerms(
        compute_s=sum(f / PEAK_FLOPS[c] for c, f in counts.flops.items()),
        memory_s=counts.hbm_bytes / HBM_BW,
        collective_s=sum(b / LINK_BW[link] for link, b in cb["per_link"].items()),
        flops_per_device=float(sum(counts.flops.values())),
        bytes_per_device=float(counts.hbm_bytes),
        collective_bytes_per_device=cb["total_bytes"],
        collective_ops=cb["num_ops"],
        per_kind=cb["per_kind"],
        flops_by_class=dict(counts.flops),
    )


def model_flops(cfg, shape, step: str) -> float:
    """Useful-work estimate: 6*N*D (train) / 2*N*D (fwd) with N = active params.

    For decode, D = tokens generated per step (= global_batch)."""
    n = cfg.active_param_count()
    if step == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if step == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence
