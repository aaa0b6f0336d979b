"""The terminal property panel and viewer of the port
(``luminary_tpu_torch/frontend/properties.py`` and ``viewer.py``), mirroring
``tests/test_properties.py`` on the port's Host on the CPU: every registry
field resolves against its live entity; edits flow through the Host's
set_<entity> API (the dirty-flag path, which restarts accumulation) and
clamp to their declared ranges; the panel renders a line per field with the
selection highlighted. The panel's lines, the half-block frame and the
folding of arrow escapes equal the JAX package's string for string."""

import numpy as np
import pytest
import torch

from luminary_tpu.frontend import properties as JP
from luminary_tpu.frontend import viewer as JV
from luminary_tpu_torch.frontend import viewer as TV
from luminary_tpu_torch.frontend.properties import (
    ENTITY_ORDER,
    PROPERTY_REGISTRY,
    PropertyPanel,
    _get,
)
from luminary_tpu_torch.host.host import Host
from luminary_tpu_torch.testing import sun_plane_scene

torch.set_num_threads(1)


def _host():
    h = Host(device="cpu")
    h.scene = sun_plane_scene(8, 8)
    return h


def test_registry_fields_all_resolve():
    h = _host()
    for ent_name, props in PROPERTY_REGISTRY.items():
        ent = getattr(h, f"get_{ent_name}")()
        for p in props:
            v = _get(ent, p.attr)
            if p.kind == "vec3":
                assert len(v) >= 3
            else:
                assert v is not None
    h.destroy()
    # the same registry as the JAX package's
    assert ENTITY_ORDER == JP.ENTITY_ORDER
    assert {k: [vars(p) for p in v] for k, v in PROPERTY_REGISTRY.items()} == {
        k: [vars(p) for p in v] for k, v in JP.PROPERTY_REGISTRY.items()}


def test_panel_edit_cycle():
    h = _host()
    panel = PropertyPanel()
    assert panel.handle_key("e", h) and panel.open
    # navigate to the ocean entity page
    while panel.entity != "ocean":
        panel.handle_key("]", h)
    # field 0 is 'active' (bool): space toggles through the Host API
    assert PROPERTY_REGISTRY["ocean"][0].attr == "active"
    assert not h.get_ocean().active
    panel.handle_key(" ", h)
    assert h.get_ocean().active
    # select 'height' and bump it twice (+0.25 each)
    while PROPERTY_REGISTRY["ocean"][panel.field_i].attr != "height":
        panel.handle_key("n", h)
    h0 = h.get_ocean().height
    panel.handle_key(".", h)
    panel.handle_key(".", h)
    assert h.get_ocean().height == np.float32(h0 + 0.5) or abs(
        h.get_ocean().height - (h0 + 0.5)) < 1e-6
    # camera vec3 component edit
    while panel.entity != "camera":
        panel.handle_key("[", h)
    x0 = h.get_camera().pos[0]
    panel.handle_key(".", h)
    assert abs(h.get_camera().pos[0] - (x0 + 0.5)) < 1e-6
    # int clamp: settings max depth cannot go below 1
    while panel.entity != "settings":
        panel.handle_key("]", h)
    for _ in range(30):
        panel.handle_key(",", h)
    assert h.get_settings().max_ray_depth == 1
    h.destroy()


def test_panel_renders_lines():
    h = _host()
    panel = PropertyPanel()
    assert panel.render(h) == []  # closed: no lines
    panel.handle_key("e", h)
    lines = panel.render(h)
    assert len(lines) == 1 + len(PROPERTY_REGISTRY[ENTITY_ORDER[0]])
    assert "\x1b[7m" in "".join(lines)  # a highlighted selection exists
    # string for string the JAX panel's lines over the same entities
    jp = JP.PropertyPanel()
    jp.handle_key("e", h)
    for key in ("n", "n", "]", ".", "]", "]", " ", "n"):
        assert panel.handle_key(key, h) and jp.handle_key(key, h)
        assert panel.render(h) == jp.render(h)
    h.destroy()


def test_panel_edit_restarts_accumulation():
    h = _host()
    h.renderer.render_samples(2)
    assert h.renderer.sample_count == 2
    panel = PropertyPanel()
    panel.handle_key("e", h)
    panel.handle_key(".", h)  # camera pos.x + 0.5
    h.renderer.render_samples(1)
    assert h.renderer.sample_count == 1
    h.destroy()


@pytest.mark.parametrize("shape,cols,rows", [((16, 16, 3), 8, 4),
                                             ((37, 53, 4), 21, 9),
                                             ((5, 7, 3), 12, 6)])
def test_halfblocks_equal_the_reference(shape, cols, rows):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    got = TV._image_to_halfblocks(img, cols, rows)
    assert got == JV._image_to_halfblocks(img, cols, rows)
    lines = got.split("\n")
    assert len(lines) == rows and lines[0].count("▀") == cols


def test_viewer_halfblock_rendering():
    img = np.zeros((16, 16, 3), np.uint8)
    img[:8] = [255, 0, 0]
    img[8:] = [0, 0, 255]
    s = TV._image_to_halfblocks(img, cols=8, rows=4)
    lines = s.split("\n")
    assert len(lines) == 4
    assert "38;2;255;0;0" in lines[0]  # red top half
    assert "48;2;0;0;255" in lines[3]  # blue bottom half
    assert lines[0].count("▀") == 8


@pytest.mark.parametrize("keys", [
    ["w", "\x1b", "[", "A", "q"],
    ["\x1b", "[", "C", "\x1b", "[", "D", "e", "\x1b"],
    ["\x1b", "x", "[", "\x1b", "["],
    [],
])
def test_fold_escapes_equal_the_reference(keys):
    assert TV._fold_escapes(keys) == JV._fold_escapes(keys)


def test_viewer_without_device_needs_a_card(monkeypatch):
    """The viewer without --device wants the card and raises on a machine
    without one, before it touches the terminal."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TV.main(["--cols", "8", "--rows", "4"])


def test_async_host_destroy_ends_the_device_worker():
    """The viewer's asynchronous Host: ``destroy`` returns once the device
    worker's thread has ended, so that a viewer that quits mid-sample does
    not exit while that thread is inside a PyTorch op (which aborts)."""
    import time

    from luminary_tpu_torch.host.host import OUTPUT_HANDLE_INVALID

    h = Host(device="cpu", asynchronous=True, samples_per_step=1)
    h.scene = sun_plane_scene(8, 8)
    promise = h.request_output(2)
    handle, t0 = OUTPUT_HANDLE_INVALID, time.monotonic()
    while handle == OUTPUT_HANDLE_INVALID and time.monotonic() - t0 < 120:
        handle = h.try_await_output(promise)
        time.sleep(0.01)
    assert handle != OUTPUT_HANDLE_INVALID
    h.request_output(1 << 20)  # keep the worker rendering
    time.sleep(0.05)
    h.destroy()
    assert not h._render_thread.is_alive()
