"""The segment planner, lbm_tpu_torch.ops.plan, and the runner's walk over
its segments, on the CPU. The pins behave as the JAX package's
(tests/test_resident.py:206-238); the plan's segments always sum to the
run and divide their steps per call; a CPU run over a main + tail plan
(every wrapper takes its plain version on CPU tensors) writes av_vels at
the right offsets and equals the unplanned run bit for bit."""

import numpy as np
import pytest
import torch

from lbm_tpu.obstacles import generate_obstacles
from lbm_tpu.params import Params
from lbm_tpu_torch import runner as trunner
from lbm_tpu_torch.ops import plan
from lbm_tpu_torch.state import initial_state

torch.set_num_threads(2)

PINS = ("LBM_RESIDENT", "LBM_RESIDENT_STEPS", "LBM_PALLAS_DEPTH",
        "LBM_RESIDENT_FORM")


@pytest.fixture
def pins(monkeypatch):
    """Start from no pins; set them with ``pins(NAME=value, ...)``."""
    for name in PINS:
        monkeypatch.delenv(name, raising=False)

    def set_pins(**values):
        for name in PINS:
            monkeypatch.delenv(name, raising=False)
        for name, value in values.items():
            monkeypatch.setenv(name, value)

    return set_pins


def _kinds(parts):
    return [(s.kernel, s.steps_per_call, s.steps) for s in parts]


@pytest.mark.parametrize("env", [
    {}, {"LBM_RESIDENT": "1"}, {"LBM_RESIDENT": "0"},
    {"LBM_RESIDENT": "0", "LBM_PALLAS_DEPTH": "1"},
    {"LBM_RESIDENT": "0", "LBM_PALLAS_DEPTH": "8"},
    {"LBM_RESIDENT": "1", "LBM_RESIDENT_STEPS": "6"},
], ids=["auto", "resident", "no-resident", "step-only", "depth-8",
        "resident-pinned-6"])
@pytest.mark.parametrize("ny,nx", [(64, 64), (1024, 1024), (1024, 16384)])
def test_segments_cover_the_run_and_divide_their_calls(pins, env, ny, nx):
    pins(**env)
    for iters in [*range(1, 230), 1099, 2002, 20000, 20001, 40000, 39999]:
        parts = plan.segments(ny, nx, iters)
        assert sum(s.steps for s in parts) == iters
        for s in parts:
            assert s.steps > 0 and s.steps % s.steps_per_call == 0
            assert s.kernel in ("step", "depth", "resident")
        # The one-step kernel runs at most one tail step.
        assert sum(s.steps for s in parts if s.kernel == "step") <= 1 or \
            env.get("LBM_PALLAS_DEPTH") == "1"


def test_official_lengths_plan_as_one_segment(pins):
    for ny, nx in [(1024, 1024), (1024, 16384), (128, 131072), (128, 128)]:
        for iters in (20000, 40000, 2000):
            assert len(plan.segments(ny, nx, iters)) == 1


def test_odd_length_plans_a_main_segment_and_a_short_tail(pins):
    main, tail = plan.segments(1024, 1024, 20001)
    assert main.steps == 20000 and main.kernel != "step"
    assert tail == plan.Segment("step", 1, 1)
    pins(LBM_RESIDENT="1")
    assert _kinds(plan.segments(1024, 1024, 20001)) == [
        ("resident", 100, 20000), ("step", 1, 1)]


def test_resident_pins(pins):
    """Off, forced, pinned; an odd or invalid pin raises (the JAX
    package's _pinned_steps)."""
    big = (1024, 1024)
    pins(LBM_RESIDENT="1")
    assert plan.resident_prefs(*big) == plan.G_PREF
    assert plan.select(*big, 20) == ("resident", 20)
    assert plan.plan_iters(*big, 20) == (20, 0)
    assert plan.plan_iters(*big, 150) == (150, 0)  # G=50 divides
    assert plan.plan_iters(*big, 101) == (100, 1)  # resident main + tail
    pins(LBM_RESIDENT="1", LBM_RESIDENT_STEPS="10")
    assert plan.resident_prefs(*big) == (10,)
    assert plan.select(*big, 20) == ("resident", 10)
    pins(LBM_RESIDENT="0")
    assert plan.resident_prefs(64, 64) is None
    assert plan.select(64, 64, 20)[0] != "resident"
    for bad, match in [("7", "even"), ("0", "positive"), ("-2", "positive"),
                       ("ten", "not an integer")]:
        pins(LBM_RESIDENT="1", LBM_RESIDENT_STEPS=bad)
        with pytest.raises(ValueError, match=match):
            plan.segments(*big, 20)


def test_depth_pins(pins):
    pins(LBM_RESIDENT="0", LBM_PALLAS_DEPTH="1")
    assert plan.depth_preference(1024, 1024) == []
    assert _kinds(plan.segments(1024, 1024, 20)) == [("step", 1, 20)]
    pins(LBM_RESIDENT="0", LBM_PALLAS_DEPTH="4")
    assert plan.depth_preference(1024, 1024) == [4, 2]
    assert _kinds(plan.segments(1024, 1024, 20000)) == [("depth", 4, 20000)]
    assert _kinds(plan.segments(1024, 1024, 22)) == [
        ("depth", 4, 20), ("depth", 2, 2)]
    pins(LBM_RESIDENT="0", LBM_PALLAS_DEPTH="16")
    assert plan.depth_preference(1024, 1024) == [8, 4, 2]
    assert _kinds(plan.segments(1024, 1024, 21)) == [
        ("depth", 8, 16), ("depth", 4, 4), ("step", 1, 1)]


def test_automatic_choice_is_resident_small_and_depth_large(pins):
    """Resident up to RESIDENT_AUTO_MAX_CELLS (792x528, the largest
    lattice whose strips fit on chip; the on-chip form beats D=4 there on
    the H100 and the device-memory form is not 2 % faster above it),
    depth above."""
    assert plan.RESIDENT_AUTO_MAX_CELLS == 792 * 528
    assert plan.resident_prefs(528, 792) == plan.G_PREF
    assert plan.resident_prefs(528, 793) is None
    assert plan.resident_prefs(529, 792) is None
    assert plan.segments(528, 792, 20000)[0].kernel == "resident"
    assert plan.segments(1024, 16384, 20000)[0].kernel == "depth"


def test_recursive_tails(pins):
    """As lbm_tpu.runner._segments: 1099 steps with the resident kernel
    forced is 1000 at G=100 and 96 at G=32 (lbm_tpu then runs 3 single
    steps; here 2 at D=2 and 1 single step); 2002 is 2000 at G=100 and
    a 2-step tail, never 1001 launches at G=2."""
    pins(LBM_RESIDENT="1", LBM_PALLAS_DEPTH="4")
    assert _kinds(plan.segments(64, 64, 1099)) == [
        ("resident", 100, 1000), ("resident", 32, 96), ("depth", 2, 2),
        ("step", 1, 1)]
    segs = plan.segments(64, 64, 2002)
    assert [s.steps for s in segs] == [2000, 2]
    assert segs[0].steps_per_call == 100 and segs[1].kernel != "resident"
    assert plan.describe(segs) == "resident G=100 x20, depth D=2 x1"
    with pytest.raises(ValueError, match="positive"):
        plan.segments(64, 64, 0)


def _scene(iters):
    p = Params(nx=48, ny=40, max_iters=iters, reynolds_dim=10,
               density=0.1, accel=0.005, omega=1.85)
    mask = generate_obstacles(p.nx, p.ny)
    mask[:, p.nx // 3] = True
    return p, torch.from_numpy(mask)


def test_planned_cpu_run_equals_the_unplanned_run(pins):
    """37 steps as resident 32 (G=16 x2), depth 4 and 1 single step: all
    three wrappers, each writing its slice of av_vels, bit for bit the
    plain one-step loop."""
    pins(LBM_RESIDENT="1", LBM_RESIDENT_STEPS="16", LBM_PALLAS_DEPTH="4")
    p, mask = _scene(37)
    sim = trunner._Simulation(p, initial_state(p), mask, "cuda", 37)
    assert _kinds(sim.segments) == [
        ("resident", 16, 32), ("depth", 4, 4), ("step", 1, 1)]
    base = trunner._Simulation(p, initial_state(p), mask, "reference", 37)
    assert _kinds(base.segments) == [("reference", 1, 37)]
    sim.av_vels.fill_(-1.0)
    sim.run()
    base.run()
    assert torch.equal(sim.cells, base.cells)
    assert torch.equal(sim.av_vels, base.av_vels)
    assert (sim.av_vels > 0).all()


def test_plan_run_for_each_kernel(pins):
    p, _ = _scene(20000)
    assert trunner.plan_run(p, "reference", 20000) == [
        plan.Segment("reference", 1, 20000)]
    pins(LBM_RESIDENT="1")
    assert plan.describe(trunner.plan_run(p, "cuda", 20001)) == \
        "resident G=100 x200, step x1"
    assert np.isclose(sum(s.steps for s in trunner.plan_run(p, "cuda", 7)), 7)


# The resident kernel's form (csrc/resident_onchip.cu or csrc/resident.cu):
# a pure size rule over the card's SM count and per-block shared memory.
H100 = (132, 232448)


def test_onchip_blocks_and_bytes():
    assert plan.onchip_blocks(128, 128, 132) == 128
    assert plan.onchip_blocks(512, 512, 132) == 132
    assert plan.onchip_blocks(1, 4096, 132) == 1
    # The tallest strip at 73 B a cell, plus the scratch.
    assert plan.onchip_smem_bytes(512, 512, 132) == 73 * 4 * 512 + 272
    assert plan.onchip_smem_bytes(256, 1024, 132) == 73 * 2 * 1024 + 272
    assert plan.onchip_smem_bytes(128, 128, 128) == 73 * 128 + 272
    assert plan.ONCHIP_SCRATCH_BYTES == 272


@pytest.mark.parametrize("ny,nx,form", [
    (128, 128, "onchip"), (256, 256, "onchip"), (512, 512, "onchip"),
    (256, 1024, "onchip"), (512, 768, "onchip"), (384, 1024, "onchip"),
    (600, 600, "onchip"), (512, 640, "onchip"),
    # The largest: 4 rows a strip at 795 columns; 796 does not fit.
    (528, 792, "onchip"), (528, 795, "onchip"), (528, 796, "device"),
    # One more row makes strips of 5.
    (529, 792, "device"), (512, 1024, "device"), (1024, 1024, "device"),
    (128, 131072, "device"),
])
def test_resident_form_on_the_h100(ny, nx, form):
    assert plan.resident_form(ny, nx, *H100) == form


def test_resident_form_at_the_capacity_boundary():
    """Across the boundary in each input: the bytes a block is given,
    the SM count (strips of 4 rows or of 5), and a wide lattice."""
    need = plan.onchip_smem_bytes(528, 792, 132)
    assert need == 231536
    assert plan.resident_form(528, 792, 132, need) == "onchip"
    assert plan.resident_form(528, 792, 132, need - 1) == "device"
    assert plan.resident_form(529, 792, 132, H100[1]) == "device"
    assert plan.resident_form(529, 792, 133, H100[1]) == "onchip"
    # A wide 2048x128: a strip is one row. Nine-speed halo rows and their
    # mask rows in shared memory would not fit beside it; the three
    # pre-forced speeds a halo cell carries stay in L2 and take none.
    nine_speed_halos = 2 * (9 * 4 + 1) * 2048
    assert plan.onchip_smem_bytes(128, 2048, 128) + nine_speed_halos > H100[1]
    assert plan.resident_form(128, 2048, *H100) == "onchip"
    assert plan.resident_form(128, 4096, *H100) == "device"
    # Fewer SMs than rows: strips of two.
    assert plan.onchip_blocks(128, 2048, 64) == 64
    assert plan.resident_form(128, 2048, 64, H100[1]) == "device"


@pytest.mark.parametrize("nx,ny,transposed,form", [
    (4096, 64, False, "device"), (8192, 32, False, "device"),
    (400, 1024, False, "device"), (1024, 400, True, "device"),
    (3200, 128, True, "device"), (792, 528, False, "onchip")],
    ids=["4096x64", "8192x32", "400x1024", "1024x400", "3200x128",
         "792x528"])
def test_auto_plans_narrow_and_tall_lattices_on_the_device_form(
        pins, nx, ny, transposed, form):
    """Under auto, on the H100's 132 SMs and 232448 B, narrow channels
    and tall boxes up to RESIDENT_AUTO_MAX_CELLS whose strips do not fit
    on chip take the resident kernel's device-memory form (on their
    transposed rows and lanes where the layout rule transposes them);
    792x528 fits on chip."""
    p = Params(nx=nx, ny=ny, max_iters=100, reynolds_dim=10, density=0.1,
               accel=0.005, omega=1.85)
    t, rows, lanes = plan.layout(p)
    assert t == transposed
    f = plan.resident_form(rows, lanes, *H100)
    assert f == form
    assert plan.describe(plan.segments(rows, lanes, 100, f)) == \
        f"resident G=100 {'device-memory' if form == 'device' else 'on-chip'} x1"


def test_describe_names_the_form(pins):
    seg = plan.Segment("resident", 100, 80000, "onchip")
    assert seg.describe() == "resident G=100 on-chip x800"
    assert seg.launch_key == "resident_onchip"
    dev = plan.Segment("resident", 100, 20000, "device")
    assert dev.describe() == "resident G=100 device-memory x200"
    assert dev.launch_key == "resident"
    assert plan.Segment("resident", 100, 200).describe() == \
        "resident G=100 x2"
    parts = plan.segments(256, 256, 80001, form="onchip")
    assert plan.describe(parts) == "resident G=100 on-chip x800, step x1"
    assert [s.form for s in parts] == ["onchip", None]
    # The 256x256 reference scene: on chip under auto on the H100.
    assert plan.describe(plan.segments(
        256, 256, 80000, plan.resident_form(256, 256, *H100))) == \
        "resident G=100 on-chip x800"


def test_form_pin(pins):
    assert plan.pinned_form() is None
    pins(LBM_RESIDENT_FORM="device")
    assert plan.pinned_form() == "device"
    pins(LBM_RESIDENT_FORM="onchip")
    assert plan.pinned_form() == "onchip"
    pins(LBM_RESIDENT_FORM="smem")
    with pytest.raises(ValueError, match="LBM_RESIDENT_FORM"):
        plan.pinned_form()


def test_no_form_off_the_card(pins):
    """Planned for the CPU (or with no device), a resident segment names
    no form, and the CPU run takes the plain version."""
    p, _ = _scene(200)
    for device in (None, torch.device("cpu")):
        parts = trunner.plan_run(p, "cuda", 200, device=device)
        assert [s.form for s in parts] == [None]
        assert plan.describe(parts) == "resident G=100 x2"


@pytest.mark.parametrize("ny,nx,transposed", [
    (256, 1024, False), (128, 2048, False), (384, 1024, True),
    (256, 2048, True), (128, 131072, True), (512, 512, False)])
def test_layout_rule_keeps_its_own_limit(ny, nx, transposed):
    """The wide-grid layout keeps the limit it was measured at (512x512
    cells) when the resident limit moved: 1024x384 is transposed, and
    its transposed lattice (1024 rows of 384) still takes the resident
    kernel on chip."""
    assert plan.TRANSPOSED_MIN_CELLS == 512 * 512
    assert plan.transposed_layout(ny, nx) == transposed
