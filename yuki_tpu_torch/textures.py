"""Texture evaluation: port of ``yuki_tpu/textures.py``'s ``eval_texture``
(:19-52).

Point-sampled gathers from the flat texel atlas with
ImageTexture::evaluate's semantics (textures/image_texture.rs:85-106):
repeat wrap, y-flip, the -0.5 texel-centre offset and truncation toward
zero, clamped to the image.  In yuki_tpu this is XLA glue before the
shading kernel (ops/shade_fused.py:1125-1138); here it is torch indexing.
The descriptor maths go through f32 as in yuki_tpu's one-row fetch (the
offset as an exact hi/lo pair), so the index is the same.
"""

from __future__ import annotations

import torch


def eval_texture(atlas, tex_id: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """tex_id [N] int (>= 0, the caller masks), uv [N,2] -> [N,3] f32."""
    tid = tex_id.to(torch.int64)
    w = atlas.width.to(torch.float32)[tid].to(torch.int32)
    h = atlas.height.to(torch.float32)[tid].to(torch.int32)
    off = ((atlas.offset >> 12).to(torch.float32)[tid].to(torch.int32) * 4096
           + (atlas.offset & 0xFFF).to(torch.float32)[tid].to(torch.int32))
    s = uv[..., 0] - torch.floor(uv[..., 0])
    t = uv[..., 1] - torch.floor(uv[..., 1])
    t = 1.0 - t
    x = s * w.to(torch.float32) - 0.5
    y = t * h.to(torch.float32) - 0.5
    # Truncate toward zero, then clamp into the image.
    xi = torch.minimum(torch.clamp(x.to(torch.int32), min=0), w - 1)
    yi = torch.minimum(torch.clamp(y.to(torch.int32), min=0), h - 1)
    return atlas.texels[(off + yi * w + xi).to(torch.int64)]
