"""Per-device performance profiles for the host-side break-even gates
(counterpart of ``stemgnn_tpu/ops/chip_profile.py``).

The hub-dense decomposition (ops.edge_layout) decides on the host, per
graph, whether a dense count-block matmul beats the gather + scatter path
for the top-frequency nodes.  The decision comes from a small roofline model
whose constants live here, one profile per device.

  * ``v5e`` — the JAX package's measured TPU profile, kept so tests can pin
    it and build layouts identical to the JAX package's.
  * ``h100`` — a SPEC-DERIVED ESTIMATE (``calibrated=False``): the v5e
    measurements scaled by the H100 SXM data-sheet ratios (3.35 TB/s HBM,
    989 TF/s dense bf16).  Nothing in it was measured on an H100.  Its
    ``row_gather_in_kernel`` is set: a kernel reads a row at any address
    through L2, so the gather-in-kernel gate (``edge_layout._gwin_decide``)
    prices no windows, only the row reads.

``build_edge_layout`` takes an explicit ``profile``; else
:func:`current_profile` picks by ``torch.cuda.get_device_name()``, and
without a card it uses the H100 profile, the device the port's kernels
target.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipProfile:
    name: str
    # random row gather: t/row = gather_fixed_s + row_bytes / gather_bps
    gather_fixed_s: float
    gather_bps: float
    # sequential streaming rate
    seq_bps: float
    # elementwise stream rate (one read + one write stream)
    stream_bps: float
    # effective bf16 matrix-unit throughput
    mxu_bf16_flops: float
    # spec memory bandwidth (dense count-block reads)
    hbm_bps: float
    # a kernel gathers rows at any address itself (GPU: through L2); False
    # for the TPU, whose gathered kernel needs locality windows
    row_gather_in_kernel: bool = False
    calibrated: bool = False
    provenance: str = ""


V5E = ChipProfile(
    name="v5e",
    gather_fixed_s=4e-9, gather_bps=180e9,
    seq_bps=375e9, stream_bps=390e9,
    mxu_bf16_flops=150e12, hbm_bps=819e9,
    calibrated=True,
    provenance="the JAX package's TPU v5e profile (measured there)")


def _scaled(name: str, hbm: float, mxu_peak: float, note: str,
            row_gather_in_kernel: bool) -> ChipProfile:
    """Estimate a device's profile by scaling the v5e measurements: memory
    rates by the HBM ratio, the matrix rate by the peak ratio, the fixed
    gather latency kept."""
    r = hbm / V5E.hbm_bps
    m = mxu_peak / 197e12
    return ChipProfile(
        name=name,
        gather_fixed_s=V5E.gather_fixed_s,
        gather_bps=V5E.gather_bps * r,
        seq_bps=V5E.seq_bps * r,
        stream_bps=V5E.stream_bps * r,
        mxu_bf16_flops=V5E.mxu_bf16_flops * m,
        hbm_bps=hbm,
        row_gather_in_kernel=row_gather_in_kernel,
        calibrated=False,
        provenance=f"ESTIMATE scaled from the v5e profile ({note})")


H100 = _scaled("h100", 3.35e12, 989e12,
               "H100 SXM data sheet: 3.35 TB/s, 989 TF/s dense bf16",
               row_gather_in_kernel=True)

# device-name substring (lower case) -> profile; first match wins
_PROFILES = (("h100", H100),)
_DEFAULT = H100


def profile_for_name(device_name: str) -> ChipProfile:
    name = device_name.lower()
    for key, prof in _PROFILES:
        if key in name:
            return prof
    return _DEFAULT


def current_profile() -> ChipProfile:
    """The profile of CUDA device 0, else H100.  ``build_edge_layout``
    takes an explicit ``profile`` argument that wins over this."""
    import torch
    if torch.cuda.is_available():
        return profile_for_name(torch.cuda.get_device_name(0))
    return _DEFAULT
