"""RoIAlign, bilinear crop-and-pool (the port of `nafae_tpu/ops/roi_align.py`).

Each output cell of an `out_size x out_size` grid averages `sampling_ratio`²
bilinear samples of the feature map; boxes are in image coordinates and
scaled to the map by `spatial_scale`. Three forms, as in the reference:

- `roi_align`: the gather form;
- `roi_align_matmul`: the separable form out = Wy · feat · Wxᵀ
  (`detector.roi_impl=separable`, the default), two batched products;
- `roi_align_combined`: one product against the folded [P·Q, H·W] pooling
  matrix (`roi_impl=combined`).

The reference computes the separable and combined forms as plain XLA
products, outside any Pallas kernel, so here they are plain PyTorch
products with f32 sums. The TPU kernel (`roi_impl=pallas`) is
`ops/kernels/roi_align.py`.

Layouts are the reference's: feat [H,W,C], boxes [N,4] xyxy -> [N,P,P,C].
The separable and combined forms also take a leading frame axis, feat
[F,H,W,C] with boxes [F,N,4] -> [F,N,P,P,C].
"""

from __future__ import annotations

import torch

def _div(x: torch.Tensor, k: float) -> torch.Tensor:
    """x / k rounded as IEEE division: PyTorch's CUDA division by a Python
    number multiplies by its reciprocal, which differs in the last bit
    (also used by ops/grounding's int8 quantization)."""
    return x / torch.full_like(x, k)


# frames per product of the batched forms: bounds the [F,N,P,W,C] f32
# intermediate of the separable form (about 0.7 GB at 32 frames of config 5)
FRAME_CHUNK = 32


def roi_align(feat: torch.Tensor, boxes: torch.Tensor, out_size: int = 7,
              spatial_scale: float = 1.0, sampling_ratio: int = 2
              ) -> torch.Tensor:
    """feat [H,W,C], boxes [N,4] xyxy (image coords) -> [N,out,out,C]."""
    h, w, c = feat.shape
    n = boxes.shape[0]
    b = boxes * spatial_scale
    x1, y1, x2, y2 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    bw = torch.clamp(x2 - x1, min=1.0)
    bh = torch.clamp(y2 - y1, min=1.0)
    cell_w = _div(bw, out_size)                              # [N]
    cell_h = _div(bh, out_size)
    sr = sampling_ratio
    grid = _div(torch.arange(out_size * sr, device=feat.device,
                             dtype=torch.float32) + 0.5, sr)  # [S] cell units
    sx = x1[:, None] + grid[None, :] * cell_w[:, None]       # [N,S]
    sy = y1[:, None] + grid[None, :] * cell_h[:, None]

    py = torch.clamp(sy - 0.5, 0.0, h - 1.0)                 # pixel centres
    px = torch.clamp(sx - 0.5, 0.0, w - 1.0)
    y0 = torch.floor(py).long()
    x0 = torch.floor(px).long()
    y1i = torch.clamp(y0 + 1, max=h - 1)
    x1i = torch.clamp(x0 + 1, max=w - 1)
    wy1 = py - y0
    wx1 = px - x0
    f = feat.reshape(h * w, c)

    def gather(yi, xi):                                      # -> [N,S,S,C]
        idx = yi[:, :, None] * w + xi[:, None, :]
        return f[idx.reshape(n, -1)].reshape(n, yi.shape[1], xi.shape[1], c)

    wy1e = wy1[:, :, None, None]
    wx1e = wx1[:, None, :, None]
    samples = (gather(y0, x0) * (1 - wy1e) * (1 - wx1e)
               + gather(y0, x1i) * (1 - wy1e) * wx1e
               + gather(y1i, x0) * wy1e * (1 - wx1e)
               + gather(y1i, x1i) * wy1e * wx1e)             # [N,S,S,C]
    s = out_size
    return samples.reshape(n, s, sr, s, sr, c).mean(dim=(2, 4))


def _weights(lo: torch.Tensor, hi: torch.Tensor, size: int, out_size: int,
             sr: int) -> torch.Tensor:
    """Pooling weights along one axis in the TPU kernel's f32 order
    (`nafae_tpu/ops/pallas/roi_align.py::_weights`): lo, hi [...] ->
    [..., out_size, size], Wm[p,h] = Σ_s relu(1 - |pt_s - h|) / sr with
    pt_s = lo + (p + (s+0.5)/sr)·cell, clipped to [0, size-1] after -0.5."""
    extent = torch.clamp(hi - lo, min=1.0)
    cell = _div(extent, out_size)[..., None, None]
    lo = lo[..., None, None]
    dev = lo.device
    p = torch.arange(out_size, device=dev, dtype=torch.float32)[:, None]
    h = torch.arange(size, device=dev, dtype=torch.float32)[None, :]
    acc = torch.zeros(lo.shape[:-2] + (out_size, size), device=dev)
    for s in range(sr):
        # a fill, not a copy from the host: the step's CUDA graph holds it
        off = torch.full((), (s + 0.5) / sr, dtype=torch.float32, device=dev)
        pts = lo + (p + off) * cell
        pts = torch.clamp(pts - 0.5, 0.0, size - 1.0)
        acc = acc + torch.relu(1.0 - torch.abs(pts - h))
    return _div(acc, sr)


def bilinear_weights(coords: torch.Tensor, size: int, out_size: int,
                     sampling_ratio: int) -> torch.Tensor:
    """Separable bilinear pooling weights along one axis: coords (lo, hi)
    [...,2] box extent on this axis (map coords) -> [..., out_size, size],
    Wm[p,h] = mean over the cell's samples of relu(1 - |py - h|), the
    sample points clipped to [0, size-1] as the gather form clips them."""
    return _weights(coords[..., 0], coords[..., 1], size, out_size,
                    sampling_ratio)


def _weights_pair(feat: torch.Tensor, boxes: torch.Tensor, out_size: int,
                  spatial_scale: float, sampling_ratio: int):
    h, w = feat.shape[-3], feat.shape[-2]
    b = boxes.float() * spatial_scale
    # slices, not list indices: a list index is a copy from the host,
    # which the step's CUDA graph cannot hold
    wy = bilinear_weights(b[..., 1::2], h, out_size, sampling_ratio)
    wx = bilinear_weights(b[..., 0::2], w, out_size, sampling_ratio)
    return wy, wx


def _by_frames(fn, feat: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """fn on [F,H,W,C] / [F,N,4] in chunks of FRAME_CHUNK frames; a
    single frame [H,W,C] / [N,4] goes through with no frame axis."""
    if feat.dim() == 3:
        return fn(feat[None], boxes[None])[0]
    return torch.cat([fn(feat[i:i + FRAME_CHUNK], boxes[i:i + FRAME_CHUNK])
                      for i in range(0, feat.shape[0], FRAME_CHUNK)])


def roi_align_matmul(feat: torch.Tensor, boxes: torch.Tensor,
                     out_size: int = 7, spatial_scale: float = 1.0,
                     sampling_ratio: int = 2) -> torch.Tensor:
    """Separable RoIAlign, out = Wy @ feat @ Wxᵀ, no gathers. In a reduced
    feat dtype the weights are rounded to it and both products sum in f32;
    the output is in feat's dtype."""
    def run(f, bx):
        wy, wx = _weights_pair(f, bx, out_size, spatial_scale, sampling_ratio)
        wy = wy.to(f.dtype).float()
        wx = wx.to(f.dtype).float()
        mid = torch.einsum("fnph,fhwc->fnpwc", wy, f.float())
        return torch.einsum("fnqw,fnpwc->fnpqc", wx, mid).to(f.dtype)
    return _by_frames(run, feat, boxes)


def roi_align_combined(feat: torch.Tensor, boxes: torch.Tensor,
                       out_size: int = 7, spatial_scale: float = 1.0,
                       sampling_ratio: int = 2) -> torch.Tensor:
    """One-product RoIAlign: W2[(p,q),(h,w)] = wy[p,h]·wx[q,w] (one f32
    product, rounded once to feat's dtype) against the flattened map."""
    def run(f, bx):
        fr, h, w, c = f.shape
        n = bx.shape[1]
        wy, wx = _weights_pair(f, bx, out_size, spatial_scale, sampling_ratio)
        w2 = (wy[..., :, None, :, None] * wx[..., None, :, None, :]).reshape(
            fr, n, out_size * out_size, h * w)
        w2 = w2.to(f.dtype).float()
        out = torch.einsum("fnkm,fmc->fnkc", w2, f.float().reshape(fr, h * w, c))
        return out.reshape(fr, n, out_size, out_size, c).to(f.dtype)
    return _by_frames(run, feat, boxes)
