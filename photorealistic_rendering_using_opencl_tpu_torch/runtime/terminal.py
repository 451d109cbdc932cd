"""Terminal image preview: truecolor half-blocks, kitty, iTerm2 and sixel.

Port of ``photorealistic_rendering_using_opencl_tpu/runtime/terminal.py``,
numpy only: for the same image every string is the reference's, byte for
byte.  The reference displays the accumulating render in a GL window; the
terminal analogue draws the tonemapped image with 24-bit ANSI half-blocks
(U+2580: the foreground colours the top pixel, the background the bottom)
or, where the terminal has one, a raster protocol.  The interactive shell
(runtime/app.py) redraws it in place for a live progressive view.
"""
from __future__ import annotations

import base64 as _base64
import os as _os

import numpy as np

from photorealistic_rendering_using_opencl_tpu_torch.utils.image import png_bytes

_HALF = "▀"  # upper half block


def downsample(img: np.ndarray, max_cols: int, max_rows_px: int
               ) -> np.ndarray:
    """Box-average [H,W,3] uint8/float to fit a max_cols x max_rows_px/2
    character grid (2 image rows per character row)."""
    h, w = img.shape[:2]
    fx = max(1, int(np.ceil(w / max_cols)))
    fy = max(1, int(np.ceil(h / max_rows_px)))
    f = max(fx, fy)
    hh = h // f * f
    ww = w // f * f
    x = img[:hh, :ww].reshape(hh // f, f, ww // f, f, -1)
    return x.mean(axis=(1, 3))


def ansi_image(ldr: np.ndarray, max_cols: int = 64,
               max_rows: int = 28) -> str:
    """Tonemapped [H,W,3] in [0,1] -> ANSI half-block string."""
    small = downsample(np.asarray(ldr, np.float32), max_cols, max_rows * 2)
    u8 = np.clip(small[..., :3] * 255.0 + 0.5, 0, 255).astype(np.int32)
    if u8.shape[0] % 2:
        u8 = np.concatenate([u8, np.zeros_like(u8[:1])], axis=0)
    top = u8[0::2]
    bot = u8[1::2]
    lines = []
    for r in range(top.shape[0]):
        cells = []
        for c in range(top.shape[1]):
            tr, tg, tb = top[r, c]
            br, bg, bb = bot[r, c]
            cells.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                         f"\x1b[48;2;{br};{bg};{bb}m{_HALF}")
        lines.append("".join(cells) + "\x1b[0m")
    return "\n".join(lines)


CURSOR_HOME = "\x1b[H"
CLEAR = "\x1b[2J"


# ---------------------------------------------------------------------------
# Pixel-exact terminal graphics (kitty / iTerm2 / sixel), ANSI fallback
#
# The reference's core UX is a live GL window (include/GL/
# cl_gl_interop.h:30-174); modern terminals can display real raster
# frames inline, which closes the remaining gap with zero GL dependency.
# Protocol picked from the environment; PRT_TERM_GRAPHICS overrides
# (kitty | iterm2 | sixel | ansi).
# ---------------------------------------------------------------------------

def detect_protocol() -> str:
    forced = _os.environ.get("PRT_TERM_GRAPHICS", "").lower()
    if forced in ("kitty", "iterm2", "sixel", "ansi"):
        return forced
    term = _os.environ.get("TERM", "")
    prog = _os.environ.get("TERM_PROGRAM", "")
    if "kitty" in term or _os.environ.get("KITTY_WINDOW_ID"):
        return "kitty"
    if prog in ("iTerm.app", "WezTerm", "vscode") or "wezterm" in term:
        return "iterm2"
    if "sixel" in term or term.startswith(("mlterm", "yaft")):
        return "sixel"
    return "ansi"


def kitty_image(ldr) -> str:
    """Kitty graphics protocol: PNG transmitted inline (f=100, a=T)."""
    data = _base64.standard_b64encode(png_bytes(ldr))
    out = []
    first = True
    while data:
        head, data = data[:4096], data[4096:]
        m = 1 if data else 0
        ctrl = f"a=T,f=100,m={m}" if first else f"m={m}"
        out.append(f"\x1b_G{ctrl};{head.decode('ascii')}\x1b\\")
        first = False
    return "".join(out)


def iterm2_image(ldr) -> str:
    """iTerm2/WezTerm OSC 1337 inline image."""
    raw = png_bytes(ldr)
    b64 = _base64.standard_b64encode(raw).decode("ascii")
    return (f"\x1b]1337;File=inline=1;size={len(raw)};"
            f"preserveAspectRatio=1:{b64}\x07")


def sixel_image(ldr) -> str:
    """DEC sixel encoder: fixed 6x7x6 (=252-register) RGB palette,
    per-band color planes."""
    u8 = np.asarray(ldr, np.float32)
    u8 = np.clip(u8[..., :3], 0.0, 1.0)
    # quantize to the fixed palette
    qr = np.minimum((u8[..., 0] * 6).astype(np.int32), 5)
    qg = np.minimum((u8[..., 1] * 7).astype(np.int32), 6)
    qb = np.minimum((u8[..., 2] * 6).astype(np.int32), 5)
    idx = (qr * 7 + qg) * 6 + qb  # [H,W] in [0, 252)
    h, w = idx.shape
    out = ["\x1bPq"]
    # palette registers (sixel colors are 0-100 scale)
    for r in range(6):
        for g in range(7):
            for b in range(6):
                out.append(f"#{(r * 7 + g) * 6 + b};2;"
                           f"{int(r * 100 / 5)};{int(g * 100 / 6)};"
                           f"{int(b * 100 / 5)}")
    for band in range(0, h, 6):
        rows = idx[band:band + 6]
        present = np.unique(rows)
        for ci, color in enumerate(present):
            bits = np.zeros((w,), np.int32)
            for k in range(rows.shape[0]):
                bits |= (rows[k] == color).astype(np.int32) << k
            chars = (bits + 63).astype(np.uint8).tobytes().decode("latin1")
            out.append(f"#{color}" + chars
                       + ("$" if ci + 1 < len(present) else "-"))
    out.append("\x1b\\")
    return "".join(out)


def image_str(ldr, protocol: str | None = None, max_cols: int = 64,
              max_rows: int = 28) -> str:
    """Render [H,W,3] tonemapped floats with the best available protocol.

    ``max_cols``/``max_rows`` bound the on-screen size for every protocol:
    the raster protocols downscale to the character grid's pixel budget
    (~10 px/col, ~20 px/row for typical cell metrics) so interactive mode
    doesn't re-transmit full-resolution frames each refresh.
    """
    proto = protocol or detect_protocol()
    if proto in ("kitty", "iterm2", "sixel"):
        img = np.asarray(ldr, np.float32)
        budget_w, budget_h = max_cols * 10, max_rows * 20
        h, w = img.shape[:2]
        if h > budget_h or w > budget_w:
            img = downsample(img, budget_w, budget_h)
        if proto == "kitty":
            return kitty_image(img)
        if proto == "iterm2":
            return iterm2_image(img)
        return sixel_image(img)
    return ansi_image(ldr, max_cols=max_cols, max_rows=max_rows)
