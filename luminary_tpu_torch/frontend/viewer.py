"""Interactive terminal viewer, the Mandarin Duck DEFAULT-mode counterpart.

The reference frontend is an SDL3 window with a fly camera and property UI
(reference: src/mandarin_duck/mandarin_duck.c:141-184 DEFAULT loop,
camera_handler.c). This dependency-free stand-in renders the recurring
output as 24-bit ANSI half-blocks in the terminal (two pixels per character
cell) and drives the same public Host API:

    python -m luminary_tpu_torch.frontend.viewer scene.lum [--width 192]
        [--device DEV]

Keys: W/A/S/D move, R/F up/down, I/J/K/L look, +/- exposure, q quit.
The async host keeps rendering between key presses; every edit restarts
accumulation through the ordinary dirty-flag path and the undersampling
pyramid shows a coarse frame within a few hundred ms.

The port of ``luminary_tpu/frontend/viewer.py``, over the port's
asynchronous Host. ``--device`` takes the place of the reference's
``JAX_PLATFORMS``: without it the viewer renders on the first CUDA card and
fails on a machine without one; ``--device cpu`` runs the plain PyTorch
path.
"""

from __future__ import annotations

import argparse
import select
import sys
import time

import numpy as np

_CSI = "\x1b["


def _image_to_halfblocks(img: np.ndarray, cols: int, rows: int) -> str:
    """RGB8 or RGBA8 [H, W, >=3] to an ANSI string of cols x rows character
    cells (each cell two vertically stacked pixels, by U+2580)."""
    h, w = img.shape[:2]
    ys = (np.linspace(0, h - 1, rows * 2)).astype(int)
    xs = (np.linspace(0, w - 1, cols)).astype(int)
    s = img[ys][:, xs, :3].astype(int)
    top = s[0::2]
    bot = s[1::2]
    out = []
    for y in range(rows):
        line = []
        for x in range(cols):
            tr, tg, tb = top[y, x]
            br, bg, bb = bot[y, x]
            line.append(
                f"{_CSI}38;2;{tr};{tg};{tb}m{_CSI}48;2;{br};{bg};{bb}m▀"
            )
        out.append("".join(line) + f"{_CSI}0m")
    return "\n".join(out)


class _RawStdin:
    """Non-blocking raw-mode key reader (POSIX)."""

    def __enter__(self):
        import termios
        import tty

        self.fd = sys.stdin.fileno()
        self.old = termios.tcgetattr(self.fd)
        tty.setcbreak(self.fd)
        return self

    def __exit__(self, *a):
        import termios

        termios.tcsetattr(self.fd, termios.TCSADRAIN, self.old)

    def keys(self):
        out = []
        while select.select([sys.stdin], [], [], 0)[0]:
            out.append(sys.stdin.read(1))
        return out


def _fold_escapes(keys: list[str]) -> list[str]:
    """ESC [ X arrow sequences to their final letter (A/B/C/D)."""
    out = []
    i = 0
    while i < len(keys):
        if keys[i] == "\x1b" and i + 2 < len(keys) and keys[i + 1] == "[":
            out.append(keys[i + 2])
            i += 3
        else:
            out.append(keys[i])
            i += 1
    return out


def run_viewer(host, cols: int = 96, rows: int = 40, max_fps: float = 8.0):
    """Drive the recurring-output loop against an asynchronous Host."""
    from .properties import PropertyPanel

    cam = host.get_camera()
    panel = PropertyPanel()
    move, turn = 0.6, 0.12
    promise = host.request_output(sample_count=1 << 20)  # drives the loop
    sys.stdout.write(f"{_CSI}2J")  # clear
    last = 0.0
    with _RawStdin() as kb:
        while True:
            dirty = False
            for k in _fold_escapes(kb.keys()):
                if k == "q":
                    return promise
                if panel.handle_key(k, host):
                    # panel edits flow through set_<entity>; re-fetch the
                    # camera so fly keys don't clobber a panel camera edit
                    cam = host.get_camera()
                    sys.stdout.write(f"{_CSI}2J")
                    continue
                p = list(cam.pos)
                rx, ry, rz = cam.rotation
                fwd = (-np.sin(ry) * np.cos(rx), np.sin(rx),
                       -np.cos(ry) * np.cos(rx))
                right = (np.cos(ry), 0.0, -np.sin(ry))
                if k == "w":
                    p = [p[i] + fwd[i] * move for i in range(3)]
                elif k == "s":
                    p = [p[i] - fwd[i] * move for i in range(3)]
                elif k == "a":
                    p = [p[i] - right[i] * move for i in range(3)]
                elif k == "d":
                    p = [p[i] + right[i] * move for i in range(3)]
                elif k == "r":
                    p[1] += move
                elif k == "f":
                    p[1] -= move
                elif k == "i":
                    rx += turn
                elif k == "k":
                    rx -= turn
                elif k == "j":
                    ry += turn
                elif k == "l":
                    ry -= turn
                elif k == "+":
                    cam.exposure *= 1.25
                elif k == "-":
                    cam.exposure /= 1.25
                else:
                    continue
                cam.pos = tuple(p)
                cam.rotation = (rx, ry, rz)
                dirty = True
            if dirty:
                host.set_camera(cam)
            now = time.monotonic()
            if now - last >= 1.0 / max_fps:
                handle = host.acquire_output()
                img = host.get_image(handle)
                meta = host.get_image_meta(handle)
                host.release_output(handle)
                frame = _image_to_halfblocks(np.asarray(img), cols, rows)
                footer = (
                    f"\n{_CSI}0m{meta['sample_count']:5d} spp   "
                    f"{host.current_sample_time * 1e3:7.1f} ms/sample   "
                    "WASD/RF move  IJKL look  +/- exposure  e edit  q quit "
                )
                for line in panel.render(host):
                    footer += "\n" + line + f"{_CSI}K"
                sys.stdout.write(f"{_CSI}H" + frame + footer)
                sys.stdout.flush()
                last = now
            time.sleep(0.02)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Luminary terminal viewer (PyTorch/CUDA port)")
    ap.add_argument("scene", nargs="?", help=".lum or .obj scene file")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=0)
    ap.add_argument("--cols", type=int, default=96)
    ap.add_argument("--rows", type=int, default=40)
    ap.add_argument(
        "--device", default=None,
        help="torch device to render on (default: the first CUDA card)")
    args = ap.parse_args(argv)

    from ..host.host import Host

    host = Host(asynchronous=True, samples_per_step=1, device=args.device)
    if args.scene:
        if args.scene.endswith(".lum"):
            host.load_lum_file(args.scene)
        else:
            host.load_obj_file(args.scene)
    else:  # a demo scene, so that the viewer runs alone
        from ..testing import cornell_scene

        host.scene = cornell_scene(args.width, args.height or args.width)
    s = host.get_settings()
    s.width = args.width
    s.height = args.height or (args.width * args.rows * 2) // args.cols
    host.set_settings(s)
    try:
        run_viewer(host, cols=args.cols, rows=args.rows)
    finally:
        host.destroy()
        sys.stdout.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
