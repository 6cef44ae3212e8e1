"""Texture evaluation: port of ``yuki_tpu/textures.py``'s ``eval_texture``
(:19-52).

Point-sampled gathers from the flat texel atlas with
ImageTexture::evaluate's semantics (textures/image_texture.rs:85-106):
repeat wrap, y-flip, the -0.5 texel-centre offset and truncation toward
zero, clamped to the image.  In yuki_tpu this is XLA glue before the
shading kernel (ops/shade_fused.py:1125-1138); here it is torch indexing.
The descriptor maths go through f32 as in yuki_tpu's one-row fetch (the
offset as an exact hi/lo pair), so the index is the same.

``decode_image_file`` is ``yuki_tpu``'s image decoder (:54-75), on PIL,
which it imports only when called.
"""

from __future__ import annotations

import numpy as np
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


def decode_image_file(path: str) -> np.ndarray:
    """Decode an image file to linear-ish [h,w,3] float32 in [0,1].

    The reference decodes u8/u16/f32 RGB(A) without sRGB conversion
    (image_texture.rs:108-141 just scales integer samples to [0,1]);
    so does this: raw channel values / max.  Raises ImportError, naming
    PIL, where PIL is not installed."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"decoding {path} needs PIL (Pillow), which is not installed"
        ) from e

    img = Image.open(path)
    mode = img.mode
    if mode not in ("RGB", "RGBA", "I;16", "F"):
        img = img.convert("RGB")
    arr = np.asarray(img)
    if arr.dtype == np.uint8:
        out = arr.astype(np.float32) / 255.0
    elif arr.dtype == np.uint16:
        out = arr.astype(np.float32) / 65535.0
    else:
        out = arr.astype(np.float32)
    if out.ndim == 2:
        out = np.repeat(out[..., None], 3, axis=2)
    return np.ascontiguousarray(out[..., :3])
