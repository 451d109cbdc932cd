"""Command-line application: progressive renderer and terminal viewer.

Port of ``photorealistic_rendering_using_opencl_tpu/runtime/app.py``, flag
for flag: the reference's CLI names (``-scene -width -height -hdr -alpha
-encoder``) plus spp, output, seed, AOVs, checkpointing, the interactive
viewer and profiling.  ``--device`` (default ``cuda``) takes the place of
the JAX package's ``JAX_PLATFORMS``: the card unless ``--device cpu`` is
given, and no fallback.

On the card every progressive step runs the ``while`` bounce loop, so K1
(the mesh kernel) launches once per dispatch, and the export tonemaps the
image on the card with K2 before only the 8-bit result crosses to the
host; the interactive preview does the same.

``-hdr`` reads an equirect Radiance map (``utils.image.read_hdr``) that
lights the scene where rays miss, importance-sampled at every vertex.
``--sharded`` renders the frame by ``parallel.render.render_sharded`` (the
path-regeneration loop, each rank its pixels) when there is more than one
rank: under ``torchrun`` every rank joins the group and rank 0 reports and
exports; in one process with several cards it spawns a rank a card (NCCL).
With one device the render is unsharded, as in the reference.
Interactive mode is a terminal shell with the reference's key bindings and
mouse-equivalent commands; a camera edit resets the accumulation.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import select
import sys
import tempfile
import time

import numpy as np
import torch

from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
from photorealistic_rendering_using_opencl_tpu_torch.ops.tonemap import tonemap
from photorealistic_rendering_using_opencl_tpu_torch.parallel import distributed
from photorealistic_rendering_using_opencl_tpu_torch.parallel.render import render_sharded
from photorealistic_rendering_using_opencl_tpu_torch.runtime import terminal
from photorealistic_rendering_using_opencl_tpu_torch.runtime.camera import (
    KEY_BINDINGS, InteractiveCamera,
)
from photorealistic_rendering_using_opencl_tpu_torch.runtime.checkpoint import (
    load_checkpoint, save_checkpoint,
)
from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene
from photorealistic_rendering_using_opencl_tpu_torch.utils.device import (
    DEFAULT_DEVICE, resolve_device,
)
from photorealistic_rendering_using_opencl_tpu_torch.utils.image import (
    read_hdr, write_hdr, write_png,
)
from photorealistic_rendering_using_opencl_tpu_torch.utils.profiling import torch_trace

PROG = "photorealistic_rendering_using_opencl_tpu_torch"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=PROG,
        description="PyTorch/CUDA progressive Monte-Carlo path tracer")
    # the reference's flags
    p.add_argument("-scene", "--scene", default="scenes/cornell.json")
    p.add_argument("-width", "--width", type=int, default=1024)
    p.add_argument("-height", "--height", type=int, default=1024)
    p.add_argument("-hdr", "--hdr", default=None,
                   help="equirect HDR environment map (Radiance .hdr)")
    p.add_argument("-alpha", "--alpha", action="store_true",
                   help="alpha testing: transparent background")
    p.add_argument("-encoder", "--encoder", type=int, default=0,
                   choices=(0, 1), help="0=PNG (tonemapped), 1=HDR")
    # framework extras
    p.add_argument("-spp", "--spp", type=int, default=64)
    p.add_argument("-o", "--output", default="render.png")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--aov", default=None,
                   choices=(None,) + pathtracer.AOV_MODES)
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file; save every --checkpoint-interval "
                        "samples and resume from it when present")
    p.add_argument("--checkpoint-interval", type=int, default=32)
    p.add_argument("--interactive", action="store_true",
                   help="terminal viewer: continuous accumulation with a "
                        "live preview; reference key bindings plus "
                        "mouse-equivalent orbit/zoom/pan commands")
    p.add_argument("--preview", action="store_true", default=None,
                   help="force the live terminal preview on (default: "
                        "only when stdout is a tty)")
    p.add_argument("--no-preview", dest="preview", action="store_false")
    p.add_argument("--sharded", action="store_true",
                   help="shard pixels over the ranks of torchrun, or over "
                        "every visible card (a rank each, NCCL); one device "
                        "renders unsharded")
    p.add_argument("--phase", default="isotropic",
                   choices=("isotropic", "hg", "rayleigh"))
    p.add_argument("--pick-random-light", action="store_true",
                   help="NEE picks one light uniformly per vertex instead "
                        "of always sampling light 0 (the reference's "
                        "PICK_RANDOM_LIGHT toggle); also settable per scene "
                        "via settings.PICK_RANDOM_LIGHT")
    p.add_argument("--profile", default=None,
                   help="write a torch.profiler Chrome trace of the "
                        "progressive loop to DIR/trace.json")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device: 'cuda' (the card, default) or "
                        "'cpu'; never falls back")
    return p


def _load(args):
    env = read_hdr(args.hdr) if args.hdr else None
    cfg, scene = load_scene(args.scene, env_map=env, alpha_testing=args.alpha,
                            phase_function=args.phase,
                            device=resolve_device(args.device))
    if args.pick_random_light:
        cfg = dataclasses.replace(cfg, pick_random_light=True)
    return cfg, scene


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def ldr_u8(ldr: torch.Tensor) -> np.ndarray:
    """Display RGB(A) in [0,1] -> uint8 on the host: ``png_bytes``'s
    quantisation done on the tensor's device, so only 8 bits a channel
    cross to the host."""
    return (torch.clamp(ldr, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8).cpu().numpy()


def preview_str(img: torch.Tensor, protocol: str | None = None) -> str:
    """The viewer's frame: the image tonemapped on its device (K2 on the
    card), 8 bits a channel copied to the host, drawn by
    ``terminal.image_str``.  The reference hands ``image_str`` the float
    image, which box-averages before it quantises; quantising first may
    move a downsampled channel by 1 in 255 from the reference's."""
    ldr = ldr_u8(tonemap(img)).astype(np.float32) / np.float32(255.0)
    return terminal.image_str(ldr, protocol=protocol)


def _export(path: str, hdr_img: torch.Tensor, alpha, encoder: int) -> None:
    if encoder == 1:
        if not path.endswith(".hdr"):
            path = path.rsplit(".", 1)[0] + ".hdr"
        write_hdr(path, hdr_img.cpu().numpy())
    else:
        ldr = tonemap(hdr_img)  # K2 on the card
        if alpha is not None:
            ldr = torch.cat([ldr, torch.clamp(alpha, 0.0, 1.0)[..., None]],
                            dim=-1)
        write_png(path, ldr_u8(ldr))
    print(f"saved {path}")


def run_batch(args) -> int:
    dev = resolve_device(args.device)
    cfg, scene = _load(args)
    W, H = args.width, args.height
    cam = InteractiveCamera(resolution=(W, H)).build_render_camera().pytree(dev)

    if args.aov:
        img = pathtracer.render_aov(cfg, scene, cam, W, H, mode=args.aov)
        _export(args.output, img, None, 0)
        return 0

    state = pathtracer.progressive_init(W, H, seed=args.seed, device=dev)
    if args.checkpoint:
        try:
            state, _, _ = load_checkpoint(args.checkpoint, device=dev)
            print(f"resumed {args.checkpoint} at "
                  f"{int(state.samples)} samples")
        except FileNotFoundError:
            pass

    t0 = time.perf_counter()
    done = int(state.samples)
    try:
        with torch_trace(args.profile):
            while done < args.spp:
                state = pathtracer.progressive_step(cfg, scene, cam, state)
                done += 1
                if args.checkpoint and done % args.checkpoint_interval == 0:
                    save_checkpoint(args.checkpoint, state)
                if done % 16 == 0 or done == args.spp:
                    _sync(dev)
                    dt = time.perf_counter() - t0
                    rate = done * W * H / max(dt, 1e-9)
                    print(f"\r{done}/{args.spp} spp  "
                          f"{rate/1e6:.2f}M samples/s", end="", flush=True)
    except KeyboardInterrupt:
        print("\ninterrupted")
    print()
    _sync(dev)
    _report(W, H, done, time.perf_counter() - t0, cfg)
    if args.checkpoint:
        save_checkpoint(args.checkpoint, state)
    img, alpha = pathtracer.progressive_image(state)
    _export(args.output, img, alpha if args.alpha else None, args.encoder)
    return 0


def _ranks(args, device: torch.device) -> int:
    """How many ranks ``--sharded`` renders over: torchrun's world size,
    else one a card; 1 means the unsharded render."""
    if not args.sharded:
        return 1
    if "WORLD_SIZE" in os.environ:
        return int(os.environ["WORLD_SIZE"])
    if device.type == "cuda" and device.index is None:
        return torch.cuda.device_count()
    return 1


def run_sharded(args) -> int:
    """This rank's part of ``--sharded``: join the group, render its pixels
    (``render_sharded``, which gathers the frame); rank 0 reports and
    exports."""
    distributed.initialize(device=args.device)
    try:
        dev = distributed.rank_device(args.device)
        args = argparse.Namespace(**{**vars(args), "device": str(dev)})
        cfg, scene = _load(args)
        W, H = args.width, args.height
        cam = InteractiveCamera(resolution=(W, H)).build_render_camera().pytree(dev)
        rank, world = distributed.rank_world()
        if rank == 0:
            print(f"sharding {W}x{H} over {world} ranks "
                  f"({torch.distributed.get_backend()})")
        t0 = time.perf_counter()
        img, alpha = render_sharded(cfg, scene, cam, W, H, args.spp,
                                    seed=args.seed)
        _sync(dev)
        if rank == 0:
            _report(W, H, args.spp, time.perf_counter() - t0, cfg)
            _export(args.output, img, alpha if args.alpha else None,
                    args.encoder)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def _spawned_rank(rank: int, world: int, init: str, args) -> None:
    distributed.initialize(init, world, rank, device=args.device)
    with torch.no_grad():
        run_sharded(args)


def spawn_sharded(args, world: int) -> int:
    """``--sharded`` in one process with ``world`` cards: a rank a card."""
    with tempfile.TemporaryDirectory() as d:
        torch.multiprocessing.spawn(
            _spawned_rank, nprocs=world,
            args=(world, "file://" + os.path.join(d, "store"), args))
    return 0


def _report(w, h, spp, dt, cfg):
    n = w * h * max(spp, 1)
    print(f"{w}x{h} @ {spp} spp in {dt:.2f}s -> "
          f"{n / max(dt, 1e-9) / 1e6:.2f}M pixel-samples/s "
          f"(~{n * cfg.max_bounces / max(dt, 1e-9) / 1e6:.0f}M rays/s upper "
          f"bound)")


def _stdin_ready() -> bool:
    try:
        return bool(select.select([sys.stdin], [], [], 0.0)[0])
    except (OSError, ValueError):
        return True  # closed/odd stdin: fall back to blocking reads


def handle_command(key: str, icam, reset_cls):
    """Apply one shell command to the camera.

    Returns (new_icam, camera_changed, handled).  Besides the reference's
    keyboard map, its mouse operations map to commands:
      * left-drag rotate  -> ``orbit DX DY`` (changeYaw/changePitch x0.01)
      * right-drag / scroll zoom -> ``zoom D`` and the +/- keys
      * middle-drag pan   -> ``pan DY`` (changeAltitude x0.01)
    """
    parts = key.split()
    op = parts[0] if parts else ""
    try:
        nums = [float(x) for x in parts[1:]]
    except ValueError:
        return icam, False, False
    if op == "orbit" and len(nums) == 2:
        icam.change_yaw(nums[0] * 0.01)
        icam.change_pitch(-nums[1] * 0.01)
        return icam, True, True
    if op == "zoom" and len(nums) == 1:
        icam.change_radius(-nums[0] * 0.01)
        return icam, True, True
    if op == "pan" and len(nums) == 1:
        icam.change_altitude(-nums[0] * 0.01)
        return icam, True, True
    if op == "+":
        icam.change_radius(-0.05)
        return icam, True, True
    if op == "-":
        icam.change_radius(0.05)
        return icam, True, True
    if key in ("space", " "):
        return reset_cls(), True, True
    if key in KEY_BINDINGS:
        KEY_BINDINGS[key](icam)
        return icam, True, True
    return icam, False, False


def run_interactive(args) -> int:
    dev = resolve_device(args.device)
    cfg, scene = _load(args)
    W, H = args.width, args.height
    icam = InteractiveCamera(resolution=(W, H))
    state = pathtracer.progressive_init(W, H, seed=args.seed, device=dev)
    preview = args.preview or (args.preview is None and sys.stdout.isatty())

    print("interactive viewer -- accumulates continuously; commands:")
    print("  w/a/s/d/r/f move   g/h aperture   t/y focal   "
          "left/right/up/down orbit keys")
    print("  orbit DX DY (mouse rotate)   zoom D / + / - (scroll)   "
          "pan DY (middle drag)")
    print("  space reset camera   p save image   n samples   q quit")
    if preview:
        sys.stdout.write(terminal.CLEAR)

    def reset_cls():
        return InteractiveCamera(resolution=(W, H))

    running = True
    while running:
        # accumulate continuously (the reference's free-running render
        # loop) until input arrives
        state = pathtracer.progressive_step(
            cfg, scene, icam.build_render_camera().pytree(dev), state)
        n = int(state.samples)  # also the completion barrier
        if preview and (n <= 2 or n % 4 == 0):
            img, _ = pathtracer.progressive_image(state)
            sys.stdout.write(terminal.CURSOR_HOME + preview_str(img)
                             + f"\n[{n} spp] > \x1b[K")
            sys.stdout.flush()
        if not _stdin_ready():
            continue
        line = sys.stdin.readline()
        if not line:
            break
        key = line.strip().lower()
        if not key:
            continue
        if key == "q":
            running = False
        elif key == "p":
            img, alpha = pathtracer.progressive_image(state)
            _export(args.output, img, alpha if args.alpha else None,
                    args.encoder)
        elif key == "n":
            print(f"\n{n} samples accumulated")
        else:
            icam, changed, handled = handle_command(key, icam, reset_cls)
            if changed:
                state = pathtracer.progressive_reset(state)
            elif not handled:
                print(f"\nunknown command {key!r}")
    img, alpha = pathtracer.progressive_image(state)
    _export(args.output, img, alpha if args.alpha else None, args.encoder)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"{PROG}: {e}", file=sys.stderr)
        return 1
    ranks = _ranks(args, dev)
    if ranks > 1 and (args.aov or args.interactive):
        print(f"{PROG}: --sharded renders a batch frame; --aov and "
              "--interactive run in one process", file=sys.stderr)
        return 1
    with torch.no_grad():
        if ranks > 1:
            if "WORLD_SIZE" in os.environ:
                return run_sharded(args)
            return spawn_sharded(args, ranks)
        if args.interactive:
            return run_interactive(args)
        return run_batch(args)


if __name__ == "__main__":
    sys.exit(main())
