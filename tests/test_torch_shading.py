"""Shading building blocks of the port against the JAX package, per function,
on inputs made with numpy from a seed (no full scene pack).

Integers and booleans must be exactly equal. Floats are held to
``rtol=1e-5, atol=1e-6`` on at least 99.9 % of lanes and to rtol 1e-4 on
all: the same float32 formulas run in both, but XLA's and PyTorch's CPU
sin, cos, sqrt, exp and log disagree in the last place on 0.6-18 % of inputs
(measured on 10^6 uniform arguments), and a sampled direction that is
normalised from a near-cancelling sum amplifies one ulp on a few lanes."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from luminary_tpu.ops import camera as jcam
from luminary_tpu.ops import ggx as jggx
from luminary_tpu.ops import lights as jlights
from luminary_tpu.ops import material as jmat
from luminary_tpu.ops import random as jr
from luminary_tpu.ops.vec import Vec3 as JVec3
from luminary_tpu.ops.wavefront_utils import sample_sun_direction as j_sun_dir
from luminary_tpu.render.device_scene import pack_light_slot_rows as j_lsr
from luminary_tpu_torch.ops import camera as tcam
from luminary_tpu_torch.ops import ggx as tggx
from luminary_tpu_torch.ops import lights as tlights
from luminary_tpu_torch.ops import material as tmat
from luminary_tpu_torch.ops import random as tr
from luminary_tpu_torch.ops.vec import Vec3
from luminary_tpu_torch.ops.wavefront_utils import sample_sun_direction
from luminary_tpu_torch.render.device_scene import HostGeometry, pack_light_slot_rows
from luminary_tpu_torch.scene.entities import Camera

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
N = 4096


def close(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=ATOL)
    tight = np.abs(got - ref) <= ATOL + RTOL * np.abs(ref)
    assert tight.mean() >= 0.999, tight.mean()


def exact(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert np.array_equal(got, np.asarray(ref))


def _ids(seed, n=N):
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, 2**31, n).astype(np.uint32)
    px = rng.integers(0, 1920, n).astype(np.int32)
    py = rng.integers(0, 1080, n).astype(np.int32)
    return pid, px, py


def _bn(px, py):
    return (jr.blue_base(jnp.asarray(px), jnp.asarray(py)),
            tr.blue_base(torch.as_tensor(px), torch.as_tensor(py)))


def _unit(rng, n):
    v = rng.standard_normal((n, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _vj(a):
    return JVec3(*(jnp.asarray(np.ascontiguousarray(a[:, i])) for i in range(3)))


def _vt(a):
    return Vec3(*(torch.as_tensor(np.ascontiguousarray(a[:, i])) for i in range(3)))


@pytest.mark.parametrize("lens", ["pinhole", "round", "bladed"])
def test_generate_camera_rays(lens):
    cam = Camera()
    cam.pos = (1.0, 2.0, -3.0)
    cam.rotation = (-0.28, 3.9, 0.1)
    cam.thin_lens.fov = 0.9
    if lens != "pinhole":
        cam.thin_lens.aperture_size = 0.4
        cam.object_distance = 25.0
        cam.aperture_shape = 1 if lens == "bladed" else 0
        cam.aperture_blade_count = 6
    pid, px, py = _ids(1)
    bn_j, bn_t = _bn(px, py) if lens != "pinhole" else (None, None)
    oj, dj = jcam.generate_camera_rays(
        jcam.pack_camera(cam), 1920, 1080, jnp.asarray(px), jnp.asarray(py),
        jnp.asarray(pid), jnp.uint32(17), bn=bn_j)
    ot, dt = tcam.generate_camera_rays(
        tcam.pack_camera(cam, "cpu"), 1920, 1080, torch.as_tensor(px),
        torch.as_tensor(py), torch.as_tensor(pid.astype(np.int64)),
        torch.tensor(17), bn=bn_t)
    for a, b in zip(ot + dt, oj + dj):
        close(a, b)


def _materials(seed, n=N):
    rng = np.random.default_rng(seed)
    translucent = rng.random(n) < 0.2
    cols = dict(
        albedo_r=rng.random(n), albedo_g=rng.random(n), albedo_b=rng.random(n),
        roughness=rng.random(n), metallic=(rng.random(n) < 0.3).astype(float),
        ior=1.0 + rng.random(n), opacity=np.ones(n))
    cols = {k: v.astype(np.float32) for k, v in cols.items()}
    thin = translucent & (rng.random(n) < 0.3)
    mj = jmat.LaneMaterial(translucent=jnp.asarray(translucent),
                           thin_walled=jnp.asarray(thin),
                           **{k: jnp.asarray(v) for k, v in cols.items()})
    mt = tmat.LaneMaterial(translucent=torch.as_tensor(translucent),
                           thin_walled=torch.as_tensor(thin),
                           **{k: torch.as_tensor(v) for k, v in cols.items()})
    ns = _unit(rng, n)
    wo = _unit(rng, n)
    flip = np.where((ns * wo).sum(-1, keepdims=True) < 0, -1.0, 1.0).astype(np.float32)
    wo = wo * flip
    return mj, mt, ns, wo, rng


def test_frame_eval():
    mj, mt, ns, wo, rng = _materials(2)
    wi = _unit(rng, N)
    fj = jmat.make_frame(mj, _vj(ns), _vj(wo))
    ft = tmat.make_frame(mt, _vt(ns), _vt(wo), torch.as_tensor(tggx.ggx_energy_quad()))
    (rj, gj, bj), pj = jmat.frame_eval(mj, fj, mj.roughness, _vj(wi))
    (rt, gt, bt), pt = tmat.frame_eval(mt, ft, mt.roughness, _vt(wi))
    for a, b in zip((rt, gt, bt, pt), (rj, gj, bj, pj)):
        close(a, b)
    close(ft.p_spec, fj.p_spec)


@pytest.mark.parametrize("blue_noise", [False, True])
def test_material_sample(blue_noise):
    """Against the reference's frame and sample compiled together with
    ``jax.jit``, as its renderer runs them: the port rounds the sampled
    direction as that compiled code does (fused multiply-adds, glibc's sin
    and cos), which the eager ops do not."""
    mj, mt, ns, wo, rng = _materials(3)
    pid, px, py = _ids(4)
    bn_j, bn_t = _bn(px, py) if blue_noise else (None, None)
    eta = (0.6 + rng.random(N)).astype(np.float32)
    jggx.ggx_energy_lut()  # cached outside the trace

    @jax.jit
    def sample_j(m, n_, w_, p_, e_, b_):
        return jmat.material_sample(m, jmat.make_frame(m, n_, w_), n_, w_, p_,
                                    jnp.uint32(9), 1, eta_rel=e_, bn=b_)

    ft = tmat.make_frame(mt, _vt(ns), _vt(wo), torch.as_tensor(tggx.ggx_energy_quad()))
    wj, wwj, pdfj, dj, trj = sample_j(mj, _vj(ns), _vj(wo), jnp.asarray(pid),
                                      jnp.asarray(eta), bn_j)
    wt, wwt, pdft, dt, trt = tmat.material_sample(
        mt, ft, _vt(ns), _vt(wo), torch.as_tensor(pid.astype(np.int64)),
        torch.tensor(9), 1, eta_rel=torch.as_tensor(eta), bn=bn_t)
    for a, b in zip(tuple(wt) + tuple(wwt), tuple(wj) + tuple(wwj)):
        close(a, b)
    # the sampled pdf of a near-mirror lobe (alpha = 0.025^2 at the roughness
    # floor) moves by up to ~10 % for a one-ulp change in the sampled
    # direction; compare it where the lobe is not that sharp
    rough = mt.roughness.numpy() >= 0.2
    close(pdft.numpy()[rough], np.asarray(pdfj)[rough])
    exact(dt, dj)
    exact(trt, trj)


def test_energy_compensation_gain():
    rng = np.random.default_rng(5)
    cos_o = rng.uniform(-0.1, 1.1, N).astype(np.float32)
    rough = rng.uniform(-0.1, 1.1, N).astype(np.float32)
    ref = jggx.energy_compensation_gain(jnp.asarray(cos_o), jnp.asarray(rough))
    got = tggx.energy_compensation_gain(torch.as_tensor(tggx.ggx_energy_quad()),
                                        torch.as_tensor(cos_o), torch.as_tensor(rough))
    close(got, ref)


def test_ggx_energy_table_matches_reference():
    exact(tggx.ggx_energy_quad(), jggx._ggx_energy_quad())


@pytest.fixture(scope="module")
def light_set():
    """300 random triangles, a third of them emissive, as both packages'
    light tables (alias + fused rows + small-table geometry)."""
    rng = np.random.default_rng(6)
    p = 300
    v0 = rng.uniform(-5, 5, (p, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.5, (p, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.5, (p, 3)).astype(np.float32)
    fn = np.cross(e1, e2)
    fn = (fn / np.linalg.norm(fn, axis=-1, keepdims=True)).astype(np.float32)
    n_mat = 6
    mat_id = rng.integers(0, n_mat, p).astype(np.int32)
    emission = rng.uniform(0, 10, (n_mat, 3)).astype(np.float32)
    emissive = np.asarray([True, False, True, False, False, True])
    valid = rng.random(p) > 0.05
    lj = jlights.pack_lights(v0, e1, e2, mat_id, emission, emissive, valid)
    lt = tlights.pack_lights_np(v0, e1, e2, mat_id, emission, emissive, valid)
    geo_j = SimpleNamespace(
        bvh=SimpleNamespace(tri_v0=_vj(v0), tri_e1=_vj(e1), tri_e2=_vj(e2)),
        face_normal=_vj(fn), material_id=jnp.asarray(mat_id))
    mats_np = {"emission_r": emission[:, 0].copy(),
               "emission_g": emission[:, 1].copy(),
               "emission_b": emission[:, 2].copy()}
    mats_j = SimpleNamespace(**{k: jnp.asarray(v) for k, v in mats_np.items()})
    rows_j = j_lsr(SimpleNamespace(
        bvh=SimpleNamespace(tri_v0=JVec3(*(v0[:, i] for i in range(3))),
                            tri_e1=JVec3(*(e1[:, i] for i in range(3))),
                            tri_e2=JVec3(*(e2[:, i] for i in range(3)))),
        face_normal=JVec3(*(fn[:, i] for i in range(3))), material_id=mat_id),
        SimpleNamespace(**mats_np), lj)
    hg = HostGeometry(wide=None, v0=v0, e1=e1, e2=e2, normals=None,
                      face_normal=fn, material_id=mat_id,
                      instance_id=np.zeros(p, np.int32),
                      prim_id=np.where(valid, 0, -1).astype(np.int32))
    rows_t = pack_light_slot_rows(hg, mats_np, lt)
    geo_t = SimpleNamespace(
        bvh=SimpleNamespace(tri_v0=_vt(v0), tri_e1=_vt(e1), tri_e2=_vt(e2)),
        face_normal=_vt(fn), material_id=torch.as_tensor(mat_id))
    mats_t = SimpleNamespace(**{k: torch.as_tensor(v) for k, v in mats_np.items()})
    return dict(lj=jax.device_put(lj), lt=tlights.lights_to_device(lt, "cpu"),
                lt_np=lt, rows_j=jnp.asarray(rows_j), rows_t=torch.as_tensor(rows_t),
                geo_j=geo_j, geo_t=geo_t, mats_j=mats_j, mats_t=mats_t)


def test_light_tables_match_reference(light_set):
    lj, lt = light_set["lj"], light_set["lt_np"]
    for k in ("prob", "alias", "slot", "select_pdf", "slot_select_pdf", "slot_area"):
        exact(lt[k], getattr(lj, k))
    assert lt["num_lights"] == int(lj.num_lights)
    exact(light_set["rows_t"], light_set["rows_j"])


@pytest.mark.parametrize("path", ["fused_alias", "small_table", "tree_candidate"])
def test_sample_light_point(light_set, path):
    s = light_set
    pid, px, py = _ids(7)
    bn_j, bn_t = _bn(px, py)
    kw_j, kw_t = {}, {}
    if path == "tree_candidate":
        rng = np.random.default_rng(8)
        l = int(s["lt"].num_lights)
        cand = rng.integers(-1, l, N).astype(np.int32)
        pdf = rng.uniform(0.0, 0.2, N).astype(np.float32)
        ok = cand >= 0
        kw_j = dict(slot=jnp.asarray(cand), pdf_select=jnp.asarray(pdf),
                    sel_valid=jnp.asarray(ok))
        kw_t = dict(slot=torch.as_tensor(cand), pdf_select=torch.as_tensor(pdf),
                    sel_valid=torch.as_tensor(ok))
    rows_j = None if path == "small_table" else s["rows_j"]
    rows_t = None if path == "small_table" else s["rows_t"]
    ref = jlights.sample_light_point(
        s["lj"], rows_j, jnp.asarray(pid), jnp.uint32(3), 10,
        geo=s["geo_j"], materials=s["mats_j"], bn=bn_j, **kw_j)
    got = tlights.sample_light_point(
        s["lt"], rows_t, torch.as_tensor(pid.astype(np.int64)), torch.tensor(3),
        10, geo=s["geo_t"], materials=s["mats_t"], bn=bn_t, **kw_t)
    slot_j, pt_j, n_j, pa_j, paa_j, em_j, ok_j, (b1_j, b2_j) = ref
    slot_t, pt_t, n_t, pa_t, paa_t, em_t, ok_t, (b1_t, b2_t) = got
    exact(slot_t, slot_j)
    exact(ok_t, ok_j)
    for a, b in zip(tuple(pt_t) + tuple(n_t) + (pa_t, paa_t) + tuple(em_t) + (b1_t, b2_t),
                    tuple(pt_j) + tuple(n_j) + (pa_j, paa_j) + tuple(em_j) + (b1_j, b2_j)):
        close(a, b)


@pytest.mark.parametrize("blue_noise", [False, True])
def test_sample_sun_direction(blue_noise):
    pid, px, py = _ids(9)
    bn_j, bn_t = _bn(px, py) if blue_noise else (None, None)
    sd = np.asarray([0.3, 0.6, -0.74], np.float32)
    sd /= np.linalg.norm(sd)
    ref = j_sun_dir(JVec3(*(jnp.float32(c) for c in sd)), jnp.asarray(pid),
                    jnp.uint32(5), 2, bn=bn_j)
    got = sample_sun_direction(Vec3(*(torch.tensor(float(c)) for c in sd)),
                               torch.as_tensor(pid.astype(np.int64)),
                               torch.tensor(5), 2, bn=bn_t)
    for a, b in zip(got, ref):
        close(a, b)
