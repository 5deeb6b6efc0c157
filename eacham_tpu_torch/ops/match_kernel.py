"""Fused descriptor matchers: the CUDA kernels, their wrappers, and their
plain PyTorch versions (port of ``match_pairs_fused`` and
``match_pair_fused``, eacham_tpu/ops/match_kernel.py).

For every frame pair the batched kernel (csrc/match_pairs.cu, bf16
operands) reduces sim = d_i . d_j^T to packed row-wise and column-wise
top-2 summaries without the similarity matrix ever reaching device
memory; the single-pair kernel (csrc/match_pair.cu) does the same for one
pair of descriptor sets of unequal sizes, with fp32 operands. The Lowe
ratio test on sqrt(2 - 2 s) in both directions and the mutual check stay
in PyTorch, in the wrappers, as in the reference.

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


def _merge_column_tiles(qr: torch.Tensor, tile_base: torch.Tensor):
    """Packed column top-2 of ``qr`` [..., nt, ROW_TILE, K2] within each row
    tile, merged across the ``nt`` tiles in order with the reference's rule.
    Returns (packed best, global argmax, packed second), each [..., K2]."""
    nt = qr.shape[-3]
    ctop = qr.amax(-2)                                     # [..., nt, K2]
    csec = torch.where(qr == ctop.unsqueeze(-2), IMIN, qr).amax(-2)
    carg = (ctop & (ROW_TILE - 1)) + tile_base
    cmax, cargm, csecm = ctop[..., 0, :], carg[..., 0, :], csec[..., 0, :]
    for i in range(1, nt):
        prev = cmax
        take = ctop[..., i, :] > prev
        csecm = torch.maximum(torch.maximum(csecm, csec[..., i, :]),
                              torch.minimum(prev, ctop[..., i, :]))
        cmax = torch.where(take, ctop[..., i, :], prev)
        cargm = torch.where(take, carg[..., i, :], cargm)
    return cmax, cargm, csecm


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
        cmax, cargm, csecm = _merge_column_tiles(qr, tile_base)
        del qr
        outs[3].append(_unpack(cmax, rbits))
        outs[4].append(cargm)
        outs[5].append(_unpack(csecm, rbits))
    if pi.shape[0] == 0:
        e = torch.empty((0, Kp), device=dev)
        return tuple(e if k % 3 != 1 else e.int() for k in range(6))
    return tuple(torch.cat(o) for o in outs)


def check_pairs_kernel_args(desc_bf: torch.Tensor, mask: torch.Tensor,
                            pair_idx: torch.Tensor):
    """Raise ValueError on anything the batched kernel does not take: desc_bf
    a contiguous, 16-byte aligned [N, Kp, 256] bf16 table (the kernel reads it
    through a TMA tensor map) with Kp a multiple of 128, mask a contiguous
    [N, Kp] uint8 tensor and pair_idx a contiguous [P, 2] int32 tensor with
    frame indices in [0, N), both on the table's device. Returns (N, Kp, P)."""
    if desc_bf.dtype != torch.bfloat16 or desc_bf.dim() != 3 \
            or desc_bf.shape[2] != DESC_DIM or not desc_bf.is_contiguous() \
            or desc_bf.data_ptr() % 16:
        raise ValueError("desc must be a contiguous, 16-byte aligned [N, Kp, 256] bf16 tensor")
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
    return N, Kp, P


def match_pairs_kernel(desc_bf: torch.Tensor, mask: torch.Tensor,
                       pair_idx: torch.Tensor):
    """Launch csrc/match_pairs.cu on CUDA tensors; same contract as
    ``match_pairs_plain``. Counts its launches in ``.launches``."""
    from eacham_tpu_torch.ops.build import load

    if not desc_bf.is_cuda:
        raise ValueError("match_pairs_kernel takes CUDA tensors")
    N, Kp, P = check_pairs_kernel_args(desc_bf, mask, pair_idx)

    lib = load("match_pairs")
    if Kp > lib.match_pairs_max_kp():
        raise ValueError(f"Kp={Kp} exceeds the kernel's shared-memory limit "
                         f"({lib.match_pairs_max_kp()})")
    lib.match_pairs_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 7)
    lib.match_pairs_error_string.restype = ctypes.c_char_p
    dev = desc_bf.device
    outs = [torch.empty((P, Kp), dtype=dt, device=dev)
            for dt in (torch.float32, torch.int32, torch.float32) * 2]
    if P == 0 or Kp == 0:
        return tuple(outs)
    with torch.cuda.device(dev):
        err = lib.match_pairs_launch(
            desc_bf.data_ptr(), mask.data_ptr(), pair_idx.data_ptr(),
            N, P, Kp, _bits(Kp), *(o.data_ptr() for o in outs),
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


def _ratio_ok(best: torch.Tensor, second: torch.Tensor, ratio: float):
    dbest = torch.sqrt(torch.clamp(2.0 - 2.0 * best, min=0.0))
    dsecond = torch.sqrt(torch.clamp(2.0 - 2.0 * second, min=0.0))
    return dbest < ratio * dsecond


def decide(raw, mask: torch.Tensor, pair_idx: torch.Tensor, ratio: float):
    """Lowe ratio on L2 distances (d^2 = 2 - 2 s), both directions, plus the
    mutual check. Returns (match_j [P, Kp] int32, valid [P, Kp] bool)."""
    b1, a1, s1, b2, a2, s2 = raw
    live = mask.bool()
    pi = pair_idx.long()
    mask1 = live[pi[:, 0]]
    mask2 = live[pi[:, 1]]
    ok1 = _ratio_ok(b1, s1, ratio) & (b1 > NEG / 2) & mask1
    ok2 = _ratio_ok(b2, s2, ratio) & (b2 > NEG / 2) & mask2
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


def match_pair_plain(d1: torch.Tensor, d2: torch.Tensor,
                     mask1: torch.Tensor, mask2: torch.Tensor):
    """The single-pair kernel's function in plain torch ops.

    d1 [K1, D], d2 [K2, D] fp32, mask1 [K1], mask2 [K2] bool. Operands and
    products are fp32; ``cbits`` spans the unpadded K2, the column packing
    spans 128-row tiles of d1 (rows past K1 are dead). Returns the six raw
    outputs: row best, row argmax, row second, each [K1]; column best,
    column argmax, column second, each [K2].
    """
    K1, K2 = d1.shape[0], d2.shape[0]
    cbits, rbits = _bits(K2), _bits(ROW_TILE)
    dev = d1.device
    alive = mask1.bool()[:, None] & mask2.bool()[None, :]
    q = torch.round(torch.matmul(d1, d2.t()) * QSCALE).to(torch.int32)
    cols = torch.arange(K2, dtype=torch.int32, device=dev)
    rows = (torch.arange(K1, dtype=torch.int32, device=dev) % ROW_TILE)[:, None]

    qc = torch.where(alive, q * (1 << cbits) | cols, IMIN)
    top = qc.amax(1)
    sec = torch.where(qc == top[:, None], IMIN, qc).amax(1)

    nt = -(-K1 // ROW_TILE)
    qr = torch.where(alive, q * (1 << rbits) | rows, IMIN)
    qr = F.pad(qr, (0, 0, 0, nt * ROW_TILE - K1), value=IMIN).view(nt, ROW_TILE, K2)
    tile_base = (torch.arange(nt, dtype=torch.int32, device=dev) * ROW_TILE)[:, None]
    cmax, carg, csec = _merge_column_tiles(qr, tile_base)
    return (_unpack(top, cbits), top & ((1 << cbits) - 1), _unpack(sec, cbits),
            _unpack(cmax, rbits), carg, _unpack(csec, rbits))


def match_pair_kernel(d1: torch.Tensor, d2: torch.Tensor,
                      mask1: torch.Tensor, mask2: torch.Tensor):
    """Launch csrc/match_pair.cu on CUDA tensors; same contract as
    ``match_pair_plain``. Counts its launches in ``.launches``."""
    from eacham_tpu_torch.ops.build import load

    if not d1.is_cuda:
        raise ValueError("match_pair_kernel takes CUDA tensors")
    dev = d1.device
    for name, d in (("d1", d1), ("d2", d2)):
        if d.device != dev or d.dtype != torch.float32 or d.dim() != 2 \
                or d.shape[1] != DESC_DIM or d.shape[0] == 0 \
                or not d.is_contiguous() or d.data_ptr() % 16:
            raise ValueError(f"{name} must be a non-empty, contiguous, 16-byte aligned "
                             f"[K, {DESC_DIM}] fp32 tensor on {dev}")
    K1, K2 = d1.shape[0], d2.shape[0]
    for name, m, K in (("mask1", mask1, K1), ("mask2", mask2, K2)):
        if m.device != dev or m.dtype != torch.bool or tuple(m.shape) != (K,) \
                or not m.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [{K}] bool tensor on {dev}")

    lib = load("match_pair")
    lib.match_pair_scratch_ints.argtypes = [ctypes.c_int] * 2
    lib.match_pair_scratch_ints.restype = ctypes.c_longlong
    lib.match_pair_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 8)
    lib.match_pair_error_string.restype = ctypes.c_char_p
    scratch = torch.empty(lib.match_pair_scratch_ints(K1, K2), dtype=torch.int32, device=dev)
    outs = [torch.empty(K, dtype=dt, device=dev)
            for K in (K1, K2) for dt in (torch.float32, torch.int32, torch.float32)]
    with torch.cuda.device(dev):
        err = lib.match_pair_launch(
            d1.data_ptr(), d2.data_ptr(), mask1.data_ptr(), mask2.data_ptr(),
            K1, K2, _bits(K2), scratch.data_ptr(), *(o.data_ptr() for o in outs),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("match_pair kernel launch failed: "
                           + lib.match_pair_error_string(err).decode())
    match_pair_kernel.launches += 1
    return tuple(outs)


match_pair_kernel.launches = 0


def match_pair_fused(d1: torch.Tensor, d2: torch.Tensor, mask1: torch.Tensor,
                     mask2: torch.Tensor, ratio: float = 0.8):
    """Fused matching of one pair of descriptor sets.

    d1 [K1, D], d2 [K2, D] L2-normalized fp32, mask1 [K1], mask2 [K2] bool.
    Returns ``(match_j [K1] int32, valid [K1] bool)``: Lowe ratio on L2
    distances (d^2 = 2 - 2 s) in both directions plus the mutual check. The
    kernel for CUDA tensors, the plain version for CPU tensors.
    """
    d1 = d1.to(torch.float32).contiguous()
    d2 = d2.to(torch.float32).contiguous()
    mask1 = mask1.bool().contiguous()
    mask2 = mask2.bool().contiguous()
    if d1.is_cuda:
        raw = match_pair_kernel(d1, d2, mask1, mask2)
    elif d1.device.type == "cpu":
        raw = match_pair_plain(d1, d2, mask1, mask2)
    else:
        raise ValueError(f"no matcher for device {d1.device}")
    b1, a1, s1, b2, a2, s2 = raw
    ok1 = _ratio_ok(b1, s1, ratio) & (b1 > NEG / 2) & mask1
    ok2 = _ratio_ok(b2, s2, ratio) & (b2 > NEG / 2) & mask2
    a1l = a1.long()
    mutual = a2[a1l] == torch.arange(d1.shape[0], device=d1.device)
    return a1, ok1 & mutual & ok2[a1l]
