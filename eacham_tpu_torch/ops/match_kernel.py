"""Batched fused descriptor matcher: the CUDA kernel, its wrapper, and its
plain PyTorch version (port of ``match_pairs_fused``,
eacham_tpu/ops/match_kernel.py).

For every frame pair the kernel (csrc/match_pairs.cu) reduces
sim = d_i . d_j^T to packed row-wise and column-wise top-2 summaries
without the similarity matrix ever reaching device memory. The Lowe ratio
test on sqrt(2 - 2 s) in both directions and the mutual check stay in
PyTorch, in the wrapper, as in the reference.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises — there is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

ROW_TILE = 128       # row tile of the reference kernel; column packing spans it
DESC_DIM = 256
QSCALE = 16384.0
IMIN = -(2 ** 30)
NEG = -1e30


def _bits(n: int) -> int:
    return max(n - 1, 1).bit_length()


def prepare(desc: torch.Tensor, kp_mask: torch.Tensor):
    """Pad K to a multiple of ROW_TILE and cast descriptors to bf16.

    Returns (desc_bf [N, Kp, D] bf16, mask [N, Kp] uint8), both contiguous.
    """
    K = desc.shape[1]
    padk = (-K) % ROW_TILE
    if padk:
        desc = F.pad(desc, (0, 0, 0, padk))
        kp_mask = F.pad(kp_mask, (0, padk))
    return (desc.to(torch.bfloat16).contiguous(),
            kp_mask.to(torch.uint8).contiguous())


def _unpack(v: torch.Tensor, bits: int) -> torch.Tensor:
    return torch.where(v == IMIN, NEG,
                       torch.bitwise_right_shift(v, bits).float() / QSCALE)


def match_pairs_plain(desc_bf: torch.Tensor, mask: torch.Tensor,
                      pair_idx: torch.Tensor, chunk: int = 256):
    """The kernel's function in plain torch ops, ``chunk`` pairs at a time.

    desc_bf [N, Kp, D] bf16, mask [N, Kp], pair_idx [P, 2]. The bf16
    operands are exact in fp32, so the products are the kernel's; only the
    fp32 summation order differs. Returns the six raw outputs, each
    [P, Kp]: row best, row argmax, row second, column best, column argmax,
    column second (best/second unpacked to float, NEG where dead).
    """
    N, Kp, _ = desc_bf.shape
    cbits, rbits = _bits(Kp), _bits(ROW_TILE)
    nt = Kp // ROW_TILE
    dev = desc_bf.device
    d32 = desc_bf.float()
    live = mask.bool()
    pi = pair_idx.long()
    cols = torch.arange(Kp, dtype=torch.int32, device=dev)
    rows = torch.arange(ROW_TILE, dtype=torch.int32, device=dev).repeat(nt)[:, None]
    tile_base = (torch.arange(nt, dtype=torch.int32, device=dev) * ROW_TILE)[:, None]
    outs = [[] for _ in range(6)]
    for s in range(0, pi.shape[0], chunk):
        p = pi[s:s + chunk]
        c = p.shape[0]
        sim = torch.matmul(d32[p[:, 0]], d32[p[:, 1]].transpose(1, 2))
        alive = live[p[:, 0]][:, :, None] & live[p[:, 1]][:, None, :]
        q = torch.round(sim * QSCALE).to(torch.int32)     # round half to even
        del sim

        qc = torch.where(alive, q * (1 << cbits) | cols, IMIN)
        top = qc.amax(2)
        sec = torch.where(qc == top[..., None], IMIN, qc).amax(2)
        del qc
        outs[0].append(_unpack(top, cbits))
        outs[1].append(top & ((1 << cbits) - 1))
        outs[2].append(_unpack(sec, cbits))

        qr = torch.where(alive, q * (1 << rbits) | rows, IMIN).view(c, nt, ROW_TILE, Kp)
        ctop = qr.amax(2)                                  # [c, nt, Kp]
        csec = torch.where(qr == ctop[:, :, None], IMIN, qr).amax(2)
        del qr
        carg = (ctop & (ROW_TILE - 1)) + tile_base
        cmax, cargm, csecm = ctop[:, 0], carg[:, 0], csec[:, 0]
        for i in range(1, nt):                             # the reference's merge
            prev = cmax
            take = ctop[:, i] > prev
            csecm = torch.maximum(torch.maximum(csecm, csec[:, i]),
                                  torch.minimum(prev, ctop[:, i]))
            cmax = torch.where(take, ctop[:, i], prev)
            cargm = torch.where(take, carg[:, i], cargm)
        outs[3].append(_unpack(cmax, rbits))
        outs[4].append(cargm)
        outs[5].append(_unpack(csecm, rbits))
    if pi.shape[0] == 0:
        e = torch.empty((0, Kp), device=dev)
        return tuple(e if k % 3 != 1 else e.int() for k in range(6))
    return tuple(torch.cat(o) for o in outs)


def match_pairs_kernel(desc_bf: torch.Tensor, mask: torch.Tensor,
                       pair_idx: torch.Tensor):
    """Launch csrc/match_pairs.cu on CUDA tensors; same contract as
    ``match_pairs_plain``. Counts its launches in ``.launches``."""
    from eacham_tpu_torch.ops.build import load

    if not desc_bf.is_cuda:
        raise ValueError("match_pairs_kernel takes CUDA tensors")
    if desc_bf.dtype != torch.bfloat16 or desc_bf.dim() != 3 \
            or desc_bf.shape[2] != DESC_DIM or not desc_bf.is_contiguous():
        raise ValueError("desc must be a contiguous [N, Kp, 256] bf16 tensor")
    N, Kp, _ = desc_bf.shape
    if Kp % ROW_TILE:
        raise ValueError(f"Kp={Kp} is not a multiple of {ROW_TILE}")
    if mask.dtype != torch.uint8 or tuple(mask.shape) != (N, Kp) \
            or not mask.is_contiguous() or mask.device != desc_bf.device:
        raise ValueError("mask must be a contiguous [N, Kp] uint8 tensor on the desc device")
    if pair_idx.dtype != torch.int32 or pair_idx.dim() != 2 or pair_idx.shape[1] != 2 \
            or not pair_idx.is_contiguous() or pair_idx.device != desc_bf.device:
        raise ValueError("pair_idx must be a contiguous [P, 2] int32 tensor on the desc device")
    P = pair_idx.shape[0]
    if P and bool(((pair_idx < 0) | (pair_idx >= N)).any()):
        raise ValueError("pair_idx holds a frame index outside [0, N)")

    lib = load("match_pairs")
    if Kp > lib.match_pairs_max_kp():
        raise ValueError(f"Kp={Kp} exceeds the kernel's shared-memory limit "
                         f"({lib.match_pairs_max_kp()})")
    lib.match_pairs_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 7)
    lib.match_pairs_error_string.restype = ctypes.c_char_p
    dev = desc_bf.device
    outs = [torch.empty((P, Kp), dtype=dt, device=dev)
            for dt in (torch.float32, torch.int32, torch.float32) * 2]
    if P == 0:
        return tuple(outs)
    with torch.cuda.device(dev):
        err = lib.match_pairs_launch(
            desc_bf.data_ptr(), mask.data_ptr(), pair_idx.data_ptr(),
            P, Kp, _bits(Kp), *(o.data_ptr() for o in outs),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("match_pairs kernel launch failed: "
                           + lib.match_pairs_error_string(err).decode())
    match_pairs_kernel.launches += 1
    return tuple(outs)


match_pairs_kernel.launches = 0


def match_pairs_raw(desc_bf: torch.Tensor, mask: torch.Tensor,
                    pair_idx: torch.Tensor, chunk: int = 256):
    """The six raw outputs: the kernel for CUDA tensors, the plain version
    for CPU tensors, and an error for anything else."""
    if desc_bf.is_cuda:
        return match_pairs_kernel(desc_bf, mask, pair_idx.to(torch.int32).contiguous())
    if desc_bf.device.type == "cpu":
        return match_pairs_plain(desc_bf, mask, pair_idx, chunk)
    raise ValueError(f"no matcher for device {desc_bf.device}")


def decide(raw, mask: torch.Tensor, pair_idx: torch.Tensor, ratio: float):
    """Lowe ratio on L2 distances (d^2 = 2 - 2 s), both directions, plus the
    mutual check. Returns (match_j [P, Kp] int32, valid [P, Kp] bool)."""
    b1, a1, s1, b2, a2, s2 = raw
    live = mask.bool()
    pi = pair_idx.long()
    mask1 = live[pi[:, 0]]
    mask2 = live[pi[:, 1]]

    def ratio_ok(best, second):
        dbest = torch.sqrt(torch.clamp(2.0 - 2.0 * best, min=0.0))
        dsecond = torch.sqrt(torch.clamp(2.0 - 2.0 * second, min=0.0))
        return dbest < ratio * dsecond

    ok1 = ratio_ok(b1, s1) & (b1 > NEG / 2) & mask1
    ok2 = ratio_ok(b2, s2) & (b2 > NEG / 2) & mask2
    a1l = a1.long()
    kp = torch.arange(a1.shape[1], device=a1.device)
    mutual = torch.gather(a2, 1, a1l) == kp[None, :]
    valid = ok1 & mutual & torch.gather(ok2, 1, a1l)
    return a1, valid


def match_pairs_fused(desc: torch.Tensor, kp_mask: torch.Tensor,
                      pair_idx: torch.Tensor, ratio: float = 0.8,
                      chunk: int = 256):
    """Batched fused matching of every pair in ``pair_idx``.

    desc [N, K, D] L2-normalized fp32, kp_mask [N, K] bool, pair_idx
    [P, 2]. Returns ``(match_j [P, K] int32, valid [P, K] bool)``. One
    kernel launch on the card; ``chunk`` bounds the plain version's memory
    on the CPU.
    """
    K = desc.shape[1]
    desc_bf, mask = prepare(desc, kp_mask)
    raw = match_pairs_raw(desc_bf, mask, pair_idx, chunk)
    match_j, valid = decide(raw, mask, pair_idx, ratio)
    return match_j[:, :K], valid[:, :K]
