"""Three-term roofline of a step on one NVIDIA H100 SXM5 80GB.

Port of ``repro.roofline``.  Per (arch x shape x mesh) cell, from the
:class:`repro_torch.costmodel.Cost` of one run of the step:

    compute term    = sum over FLOP classes of FLOPs / (chips * rate)
    memory term     = bytes       / (chips * HBM_BW)
    collective term = coll_bytes  / (chips * NVLINK_BW)

The reference divides all its FLOPs by one bf16 peak.  Here each class
of :data:`repro_torch.costmodel.CLASSES` has its own rate: products with
bf16 operands at the tensor cores' bf16 peak, and products with f32
operands, and everything else, at the f32 rate outside the tensor
cores, since the port runs with TF32 off.  A training step's backward
products are f32 (``models.common._Mm32`` widens the narrow operand), so
with the single bf16 peak its compute term would be about 15x too low on
that half.  Collective bytes come from the dispatched ops
(``Cost.coll_bytes``), each rank's own; there is no HLO, so
``xla_flops`` and ``xla_bytes`` are ``None``.

``MODEL_FLOPS`` = 6*N*D (dense) or 6*N_active*D (MoE) gives the useful
compute ratio, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# NVIDIA H100 SXM5 80GB data sheet, dense (no sparsity), at 700 W.
BF16_FLOPS = 989e12     # bf16 (and f16) tensor-core products, FLOP/s
TF32_FLOPS = 495e12     # TF32 tensor-core products, FLOP/s
F32_FLOPS = 67e12       # f32 outside the tensor cores, FLOP/s
HBM_BW = 3.35e12        # HBM3, bytes/s
NVLINK_BW = 450e9       # NVLink 4, bytes/s each direction
HBM_BYTES = 80e9        # device memory of one card

PEAK_FLOPS = BF16_FLOPS
CLASS_RATE = {"products_bf16": BF16_FLOPS, "products_f32": F32_FLOPS,
              "other": F32_FLOPS}


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_detail: dict
    flops_by_class: dict            # costmodel.CLASSES -> FLOPs
    model_flops: Optional[float] = None
    xla_flops = None
    xla_bytes = None

    @property
    def t_compute(self):
        return sum(f / CLASS_RATE[c] for c, f in
                   self.flops_by_class.items()) / self.chips

    @property
    def t_memory(self):
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self):
        return self.coll_bytes / (self.chips * NVLINK_BW)

    @property
    def t_bound(self):
        """The least time of the step: its largest term (compute,
        memory and collectives overlapped perfectly)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def bottleneck(self):
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self):
        if not self.model_flops or not self.hlo_flops:
            return None
        return self.model_flops / self.hlo_flops

    @property
    def t_ideal(self):
        """Useful-compute time: MODEL_FLOPS at the bf16 peak."""
        if not self.model_flops:
            return None
        return self.model_flops / (self.chips * PEAK_FLOPS)

    @property
    def roofline_fraction(self):
        """t_ideal / max(term), as the reference's."""
        binding = self.t_bound
        if not self.model_flops or binding == 0:
            return None
        return self.t_ideal / binding

    @property
    def balance(self):
        """max(term)/sum(terms): 1.0 = single dominant roof."""
        tot = self.t_compute + self.t_memory + self.t_collective
        if tot == 0:
            return None
        return self.t_bound / tot

    def to_dict(self):
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "xla_flops": self.xla_flops, "xla_bytes": self.xla_bytes,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "coll_bytes": self.coll_bytes,
            "coll_detail": self.coll_detail,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "t_ideal_s": self.t_ideal,
            "roofline_fraction": self.roofline_fraction,
            "balance": self.balance,
            "flops_by_class": self.flops_by_class,
            "t_bound_s": self.t_bound,
        }


def analyze(arch, shape, mesh_name, chips, cost, model_flops=None):
    """A :class:`Roofline` from a :class:`repro_torch.costmodel.Cost`.

    The cost is one rank's (each process traces its own ops), so its
    FLOPs, bytes and collective bytes are scaled by ``chips`` to the
    global total, as the reference scales its per-device HLO shapes;
    ``coll_detail`` stays the rank's.  On one card that changes nothing.
    Where ranks repeat each other's work (the model axis of the dry
    run's ``tp`` layout, see ``launch/dryrun.py``) the total counts it
    as often."""
    return Roofline(arch=arch, shape=shape, mesh=mesh_name, chips=chips,
                    hlo_flops=cost.flops * chips,
                    hlo_bytes=cost.bytes * chips,
                    coll_bytes=float(sum(cost.coll_bytes.values())) * chips,
                    coll_detail={**cost.coll_bytes,
                                 "counts": dict(cost.coll_counts)},
                    flops_by_class={c: f * chips for c, f in
                                    cost.flops_by_class.items()},
                    model_flops=model_flops)


def count_params(module) -> int:
    """Elements of ``module``'s parameters (meta tensors count too)."""
    return sum(p.numel() for p in module.parameters())


def active_params(cfg, n_params: int) -> float:
    """MoE: active parameter count for 6*N_active*D."""
    try:
        pattern = cfg.pattern
    except AttributeError:
        return float(n_params)
    if pattern != "moe":
        return float(n_params)
    # fraction of expert params that are active: top_k (+shared) of n_experts
    e, k, sh = cfg.n_experts, cfg.top_k, cfg.n_shared
    d, f = cfg.d_model, (cfg.moe_d_ff or cfg.d_ff)
    per_expert = 3 * d * f
    expert_total = cfg.n_layers * e * per_expert
    expert_active = cfg.n_layers * (k + sh) * per_expert
    return float(n_params - expert_total + expert_active)
