"""The one traffic generator: one client in a closed loop that requests
images from the program's ``Host`` at rising sample counts, and may edit
the scene between them, as a mix's parameters (``traffic/<mix>.json``)
say:

- ``request_at``: the sample counts of the first requests, in order;
- ``then_every``: after the last of them, a request every this many
  samples more, without end (the window ends the loop);
- ``samples_per_step``: the Host's samples per poll;
- ``edit_every`` (optional, 0 by default: never): after every this many
  images, one edit of the scene; the render restarts, and the requests
  begin again at ``request_at``;
- ``edit``: the edit, ``{"entity": <name>, "field": <attribute>, "step":
  [numbers]}``: the entity's field, a tuple of numbers, moves by ``step``.

A viewer that fetches the image of every sample and moves the camera every
8 frames is ``{"request_at": [1], "then_every": 1, "samples_per_step": 1,
"edit_every": 8, "edit": {"entity": "camera", "field": "pos", "step":
[0.05, 0, 0]}}``.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass


@dataclass
class Window:
    attempted: int = 0  # images requested and delivered
    failed: int = 0  # images of the wrong shape or sample count
    samples: int = 0  # the sample count of the last image, since the last edit
    total_samples: int = 0  # full-frame samples rendered over every restart
    edits: int = 0  # edits of the scene, the warm-up's included
    seconds: float = 0.0


def targets(mix: dict):
    """The sample counts the client requests, in order, without end."""
    counts = [int(c) for c in mix["request_at"]]
    if not counts or any(b <= a for a, b in zip(counts, counts[1:])):
        raise ValueError("request_at must rise: %r" % (counts,))
    step = int(mix["then_every"])
    if step < 1:
        raise ValueError("then_every must be at least 1")
    yield from counts
    for k in itertools.count(1):
        yield counts[-1] + k * step


def edit_every(mix: dict) -> int:
    n = int(mix.get("edit_every", 0))
    if n < 0:
        raise ValueError("edit_every must be at least 0")
    if n and "edit" not in mix:
        raise ValueError("edit_every needs an edit")
    return n


def apply_edits(scene, mix: dict, count: int) -> None:
    """Make the mix's edit ``count`` times on ``scene`` (the program's
    scene, or the reference's copy of it: the same steps give the same
    numbers)."""
    if count <= 0:
        return
    e = mix["edit"]
    ent = scene.get_entity(e["entity"])
    value = tuple(getattr(ent, e["field"]))
    step = [float(s) for s in e["step"]]
    if len(step) != len(value):
        raise ValueError("edit step %r does not fit %s.%s = %r"
                         % (step, e["entity"], e["field"], value))
    for _ in range(count):
        value = tuple(v + s for v, s in zip(value, step))
    setattr(ent, e["field"], value)
    scene.set_entity(e["entity"], ent)


def fetch(host, target: int, w: Window, shape, deadline=None) -> bool:
    """Request an image at ``target`` samples and poll until it is ready
    (False where the deadline passes first); the Host copies the image to
    the host, and it is checked and released."""
    from luminary_tpu_torch.host.host import OUTPUT_HANDLE_INVALID

    promise = host.request_output(target)
    handle = host.try_await_output(promise)
    while handle == OUTPUT_HANDLE_INVALID:
        if deadline is not None and time.monotonic() >= deadline:
            return False
        handle = host.try_await_output(promise)
    got = host.get_image_meta(handle)["sample_count"]
    w.attempted += 1
    w.failed += int(host.get_image(handle).shape != shape or got < target)
    w.samples = got
    host.release_output(handle)
    return True


def _edit(host, mix: dict, w: Window) -> None:
    w.total_samples += w.samples
    w.samples = 0
    apply_edits(host.scene, mix, 1)
    w.edits += 1


def warm_up(host, mix: dict, shape) -> int:
    """One request through the window's path, and one edit with the
    request after it where the mix edits → the edits made."""
    w = Window()
    fetch(host, int(mix["request_at"][0]), w, shape)
    if edit_every(mix):
        _edit(host, mix, w)
        fetch(host, int(mix["request_at"][0]), w, shape)
    return w.edits


def run(host, mix: dict, seconds: float, shape, edits: int = 0) -> Window:
    """The mix's loop for ``seconds``, after ``edits`` edits of the
    warm-up; when the seconds have passed, the request they cut is made at
    the sample count reached, and the window closes."""
    every = edit_every(mix)
    w = Window(edits=edits)
    t_start = time.monotonic()
    deadline = t_start + seconds
    running = True
    while running:
        for k, target in enumerate(targets(mix), 1):
            if (not fetch(host, target, w, shape, deadline)
                    or time.monotonic() >= deadline):
                running = False
                break
            if every and k % every == 0:
                _edit(host, mix, w)
                break
    reached = host.renderer.sample_count
    if reached > w.samples:  # the request the window cut, at the count reached
        fetch(host, reached, w, shape)
    w.total_samples += w.samples
    w.seconds = time.monotonic() - t_start
    return w
