"""The check that decides ``correct``, on the CPU at a tiny size: the
reference against the port's plain CPU path, the bfloat16 control, and a
run driven with the timed path broken underneath, once for each fault a
cell can have."""

import json

import numpy as np
import pytest
import torch

import _tiny
from harness import cell as cell_mod
from harness import compare, spec
from harness.reference import reference_means

SEED = 2147483777
SECONDS = 4.0
# a viewer's mix: the image of every sample, the camera moved every 2 frames
VIEWER = {"request_at": [1], "then_every": 1, "samples_per_step": 1,
          "edit_every": 2,
          "edit": {"entity": "camera", "field": "pos", "step": [0.5, 0.0, 0.0]}}
_cache = {}


@pytest.fixture(autouse=True)
def cached_reference(monkeypatch):
    """One reference render per (scene, pixels, samples) for the module."""
    real = cell_mod.reference_means

    def cached(recipe, params, seed, px, py, samples, device,
               precision="float32", edit=None):
        edits = (json.dumps(edit.keywords, sort_keys=True)
                 if edit is not None else None)
        key = (tuple(sorted(params.items())), seed, px.tobytes(),
               py.tobytes(), samples, str(device), precision, edits)
        if key not in _cache:
            _cache[key] = real(recipe, params, seed, px, py, samples, device,
                               precision, edit)
        return _cache[key]

    monkeypatch.setattr(cell_mod, "reference_means", cached)


def _run(cell):
    return cell_mod.run(cell, SEED, SECONDS, False, device="cpu")


def _mismatch(out):
    return out["compared"]["mismatch_pct"]["value"]


def test_sound_run_matches_the_reference():
    out = _run(_tiny.tiny_cell())
    assert out["correct"], out["compared"]
    assert out["compared"]["samples"]["value"] >= 2
    assert _mismatch(out) == 0.0


def test_traced_run():
    """A traced run: the per-layer metrics a CPU trace holds (the pack's
    host clock; no device operation) and the same check."""
    out = cell_mod.run(_tiny.tiny_cell(chips=4),
                       SEED, SECONDS, True, device="cpu")
    assert out["correct"], out["compared"]
    assert set(out["metrics"]) == {"pack_s"}


def test_sound_mesh_run_matches_the_reference():
    out = _run(_tiny.tiny_cell(chips=4))
    assert out["correct"], out["compared"]
    assert out["compared"]["samples"]["value"] % 4 == 0


def test_sound_run_with_edits_matches_the_reference():
    """A mix that edits the scene: the reference renders the scene after the
    same edits."""
    cell = _tiny.tiny_cell()
    cell.traffic = VIEWER
    out = _run(cell)
    assert out["correct"], out["compared"]
    assert out["attempted"] >= 3
    assert out["compared"]["samples"]["value"] in (1, 2)


def test_fault_edit_never_reaches_the_render(monkeypatch):
    """The program takes the edits and renders the scene before them."""
    from luminary_tpu_torch.scene import scene as S

    real = S.Scene.set_entity
    placed = set()  # scenes whose camera the recipe has placed

    def set_entity(self, name, value):
        if name == "camera":
            if id(self) in placed:
                return S.DirtyFlags.NONE
            placed.add(id(self))
        return real(self, name, value)

    cell = _tiny.tiny_cell()
    cell.traffic = VIEWER
    monkeypatch.setattr(S.Scene, "set_entity", set_entity)
    assert not _run(cell)["correct"]


def test_control_fails():
    cell = _tiny.tiny_cell()
    params = cell.config["scene"]
    recipe = spec.load_module("scenes", cell.config["recipe"])
    px, py = compare.check_pixels(params["width"], params["height"],
                                  cell.config["check_pixels"], SEED)
    ref = reference_means(recipe, params, SEED, px, py, 4, "cpu")
    low = reference_means(recipe, params, SEED, px, py, 4, "cpu",
                          precision="bfloat16")
    ok, numbers = compare.judge(low, ref, 4, cell.config["limits"])
    assert not ok
    assert numbers["mismatch_pct"]["value"] > 50.0


def test_fault_state_unchanged(monkeypatch):
    """A step that returns its state unchanged (only the count moves)."""
    from luminary_tpu_torch.render import renderer as R

    real = R._sample_step

    def step(scene, cam, config, px, py, sample_id, accum, with_gbuffer=True):
        _, g, rays = real(scene, cam, config, px, py, sample_id, accum,
                          with_gbuffer)
        return accum._replace(sample_count=accum.sample_count + 1), g, rays

    monkeypatch.setattr(R, "_sample_step", step)
    assert not _run(_tiny.tiny_cell())["correct"]


def test_fault_half_the_samples_left_out(monkeypatch):
    """Half of the samples left out, the mean taken over the rest."""
    from luminary_tpu_torch.render import renderer as R

    real = R._sample_step

    def step(scene, cam, config, px, py, sample_id, accum, with_gbuffer=True):
        new, g, rays = real(scene, cam, config, px, py, sample_id, accum,
                            with_gbuffer)
        w = 2.0 if int(sample_id) % 2 == 0 else 0.0
        rad = accum.radiance + w * (new.radiance - accum.radiance)
        return new._replace(radiance=rad), g, rays

    monkeypatch.setattr(R, "_sample_step", step)
    out = _run(_tiny.tiny_cell())
    assert not out["correct"], out["compared"]


def test_fault_exchange_between_cards_left_out(monkeypatch):
    """The shards other than the main one never reach the main device."""
    from luminary_tpu_torch.parallel import mesh as M

    real = M.render_sample
    calls = {"n": 0}

    def render(*a, **k):
        radiance, g, rays = real(*a, **k)
        calls["n"] += 1
        if calls["n"] % 4 != 1:
            radiance = torch.zeros_like(radiance)
        return radiance, g, rays

    monkeypatch.setattr(M, "render_sample", render)
    out = _run(_tiny.tiny_cell(chips=4))
    assert not out["correct"], out["compared"]


def test_fault_answer_altered(monkeypatch):
    """Every lane's radiance altered where the sample produces it."""
    from luminary_tpu_torch.render import renderer as R

    real = R.render_sample

    def render(*a, **k):
        radiance, g, rays = real(*a, **k)
        return radiance * 1.001, g, rays

    monkeypatch.setattr(R, "render_sample", render)
    out = _run(_tiny.tiny_cell())
    assert not out["correct"], out["compared"]


def test_mismatch_counts_nan():
    r = np.ones((4, 3), np.float32)
    p = r.copy()
    p[0, 1] = np.nan
    assert compare.mismatch_pct(p, r) == 25.0
    assert compare.mismatch_pct(r, r) == 0.0


@pytest.mark.card
def test_control_fails_on_the_card(card):
    """The bfloat16 control against the reference on the card, at the
    cell's own scene and a quarter of its pixels' width."""
    cell = spec.load_cell("tree-4k.ladder")
    params = dict(cell.config["scene"], width=960, height=540)
    recipe = spec.load_module("scenes", cell.config["recipe"])
    px, py = compare.check_pixels(960, 540, cell.config["check_pixels"], SEED)
    ref = reference_means(recipe, params, SEED, px, py, 8, card)
    low = reference_means(recipe, params, SEED, px, py, 8, card,
                          precision="bfloat16")
    ok, numbers = compare.judge(low, ref, 8, cell.config["limits"])
    assert not ok
    assert numbers["mismatch_pct"]["value"] > 50.0
