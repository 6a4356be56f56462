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
        "LBM_RESIDENT_FORM", "LBM_RESIDENT_INPLACE", "LBM_RESIDENT_SHIFT")


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
    package's _pinned_steps; an odd one is taken by the single-buffer
    form alone, test_odd_g_pin_needs_the_single_buffer_form)."""
    big = (1024, 1024)
    pins(LBM_RESIDENT="1")
    assert plan.resident_prefs(*big) == plan.G_PREF
    assert _kinds(plan.segments(*big, 20)) == [("resident", 20, 20)]
    assert _kinds(plan.segments(*big, 150)) == [("resident", 50, 150)]
    assert _kinds(plan.segments(*big, 101)) == [  # resident main + tail
        ("resident", 100, 100), ("step", 1, 1)]
    pins(LBM_RESIDENT="1", LBM_RESIDENT_STEPS="10")
    assert plan.resident_prefs(*big) == (10,)
    assert _kinds(plan.segments(*big, 20)) == [("resident", 10, 20)]
    pins(LBM_RESIDENT="0")
    assert plan.resident_prefs(64, 64) is None
    assert plan.segments(64, 64, 20)[0].kernel != "resident"
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


# The resident kernel's form (csrc/resident_onchip.cu in two buffers or
# one, or csrc/resident.cu): a pure size rule over the card's SM count and
# per-block shared memory.
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
    # 796 takes the single-buffer mode (strips of 4 rows at 37 B a cell).
    (528, 792, "onchip"), (528, 795, "onchip"), (528, 796, "inplace"),
    # One more row makes strips of 5, in one buffer.
    (529, 792, "inplace"), (512, 1024, "inplace"), (1024, 1024, "device"),
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
    # Below the two buffers' bytes the single-buffer mode takes it.
    assert plan.resident_form(528, 792, 132, need - 1) == "inplace"
    one = plan.onchip_smem_bytes(528, 792, 132, 1)
    assert plan.resident_form(528, 792, 132, one - 1) == "device"
    assert plan.resident_form(529, 792, 132, H100[1]) == "inplace"
    assert plan.resident_form(529, 792, 133, H100[1]) == "onchip"
    # A wide 2048x128: a strip is one row. Nine-speed halo rows and their
    # mask rows in shared memory would not fit beside it; the three
    # pre-forced speeds a halo cell carries stay in L2 and take none.
    nine_speed_halos = 2 * (9 * 4 + 1) * 2048
    assert plan.onchip_smem_bytes(128, 2048, 128) + nine_speed_halos > H100[1]
    assert plan.resident_form(128, 2048, *H100) == "onchip"
    # 4096 wide: one-row strips fit one buffer, which auto does not take.
    assert plan.resident_form(128, 4096, *H100) == "device"
    # Fewer SMs than rows: strips of two, in one buffer.
    assert plan.onchip_blocks(128, 2048, 64) == 64
    assert plan.resident_form(128, 2048, 64, H100[1]) == "inplace"


@pytest.mark.parametrize("nx,ny,transposed,form", [
    (4096, 64, False, "device"), (8192, 32, False, "device"),
    (400, 1024, False, "inplace"), (1024, 400, True, "inplace"),
    (3200, 128, True, "inplace"), (792, 528, False, "onchip")],
    ids=["4096x64", "8192x32", "400x1024", "1024x400", "3200x128",
         "792x528"])
def test_auto_plans_narrow_and_tall_lattices_on_the_device_form(
        pins, nx, ny, transposed, form):
    """Under auto, on the H100's 132 SMs and 232448 B, narrow channels
    and tall boxes up to RESIDENT_AUTO_MAX_CELLS whose two-buffer strips do
    not fit take the on-chip form's single-buffer mode where its strips
    are at least two rows tall (400x1024, and 1024x400 and 3200x128 on
    their transposed rows and lanes), else the device-memory form (the
    one-row strips of 4096x64; 8192x32 fits neither on chip); 792x528
    fits two buffers on chip. (The name is the test's from before the
    single-buffer mode, when all five took the device form.)"""
    p = Params(nx=nx, ny=ny, max_iters=100, reynolds_dim=10, density=0.1,
               accel=0.005, omega=1.85)
    t, rows, lanes = plan.layout(p)
    assert t == transposed
    f = plan.resident_form(rows, lanes, *H100)
    assert f == form
    word = {"device": "device-memory", "onchip": "on-chip",
            "inplace": "on-chip 1-buf"}[form]
    assert plan.describe(plan.segments(rows, lanes, 100, f)) == \
        f"resident G=100 {word} x1"


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


# The on-chip form's single-buffer mode ("inplace"; LBM_RESIDENT_INPLACE).


def test_onchip_bytes_in_one_buffer():
    """37 B a cell of the tallest strip, the scratch, 16 B of carried
    scalars and 12 B a column for each of min(h - 1, 2) carried rows."""
    assert plan.ONCHIP_BYTES_PER_CELL == {2: 73, 1: 37}
    assert plan.onchip_smem_bytes(64, 4096, 64, 1) == 37 * 4096 + 272 + 16
    assert plan.onchip_smem_bytes(264, 1600, 132, 1) == \
        37 * 2 * 1600 + 272 + 16 + 12 * 1600
    assert plan.onchip_smem_bytes(768, 768, 132, 1) == \
        37 * 6 * 768 + 272 + 16 + 24 * 768
    # Two buffers: unchanged.
    assert plan.onchip_smem_bytes(768, 768, 132, 2) == \
        plan.onchip_smem_bytes(768, 768, 132) == 73 * 6 * 768 + 272


def test_single_buffer_bytes_at_the_capacity_boundary():
    """Strips of 6 rows (768 over 132 blocks): 943 columns fit one
    buffer, 944 do not; a one-row strip fits up to 6274 columns, which
    auto leaves to the device form (strips of one row)."""
    assert plan.onchip_smem_bytes(768, 943, 132, 1) <= H100[1] \
        < plan.onchip_smem_bytes(768, 944, 132, 1)
    assert plan.resident_form(768, 943, *H100) == "inplace"
    assert plan.resident_form(768, 944, *H100) == "device"
    assert plan.onchip_fits(64, 6274, *H100, 1)
    assert not plan.onchip_fits(64, 6275, *H100, 1)
    assert plan.resident_form(64, 6274, *H100) == "device"
    assert plan.INPLACE_MIN_ROWS == 2


# The Motivation table of the single-buffer slice: execution rows x lanes,
# whether two and one buffers fit on the H100, and auto's form.
@pytest.mark.parametrize("rows,lanes,two,one,form", [
    (64, 4096, False, True, "device"),      # 4096x64, one-row strips
    (1024, 400, False, True, "inplace"),    # 1024x400 transposed
    (3200, 128, False, True, "inplace"),    # 3200x128 transposed
    (1024, 512, False, True, "inplace"),    # 1024x512 transposed
    (768, 768, False, True, "inplace"),
    (640, 1024, False, True, "inplace"),    # 1024x640
    (768, 1024, False, False, "device"),    # 1024x768: the carry does not fit
    (896, 896, False, False, "device"),
    (32, 8192, False, False, "device"),
    (1024, 1024, False, False, "device"),
], ids=["4096x64", "1024x400", "3200x128", "1024x512", "768x768",
        "1024x640", "1024x768", "896x896", "8192x32", "1024x1024"])
def test_single_buffer_mode_on_the_h100(rows, lanes, two, one, form):
    assert plan.onchip_fits(rows, lanes, *H100, 2) == two
    assert plan.onchip_fits(rows, lanes, *H100, 1) == one
    assert plan.resident_form(rows, lanes, *H100) == form


def test_auto_takes_single_buffer_lattices_above_the_cell_limit(pins):
    """Above RESIDENT_AUTO_MAX_CELLS the resident kernel runs where the
    planned form is the single-buffer one and the size rule takes it there
    on the card's limits (1024x512, 768x768, 1024x640); the limit stays
    for the device form, for no limits (the CPU) and where only a pin
    names the single-buffer mode (1024x1024)."""
    for rows, lanes in [(1024, 512), (768, 768), (640, 1024)]:
        assert rows * lanes > plan.RESIDENT_AUTO_MAX_CELLS
        form = plan.resident_form(rows, lanes, *H100)
        assert plan.resident_prefs(rows, lanes, form, H100) == plan.G_PREF
        assert plan.describe(plan.segments(rows, lanes, 20000, form,
                                           H100)) == \
            "resident G=100 on-chip 1-buf x200"
        assert plan.resident_prefs(rows, lanes, form) is None
        assert plan.resident_prefs(rows, lanes, "device", H100) is None
        assert plan.resident_prefs(rows, lanes) is None
    assert plan.resident_prefs(1024, 1024, "inplace", H100) is None
    pins(LBM_RESIDENT="0")
    assert plan.resident_prefs(768, 768, "inplace", H100) is None


def test_inplace_pins(pins):
    """LBM_RESIDENT_INPLACE as the JAX package reads it: "1" the
    single-buffer mode, "0", "" or "false" two buffers, where it fits or
    not (the wrapper raises where it runs); with LBM_RESIDENT_FORM=device
    "1" raises, "0" keeps the device form; LBM_RESIDENT_FORM=onchip pins
    the two buffers, where they fit or not. Off the card no form."""
    assert plan.pinned_inplace() is None
    assert plan.planned_form(64, 4096, H100) == "device"
    assert plan.planned_form(768, 768, H100) == "inplace"
    for value, form in [("1", "inplace"), ("yes", "inplace"), ("0", "onchip"),
                        ("", "onchip"), ("false", "onchip")]:
        pins(LBM_RESIDENT_INPLACE=value)
        assert plan.pinned_inplace() == (form == "inplace")
        for rows, lanes in [(256, 256), (64, 4096), (768, 768),
                            (1024, 1024)]:
            assert plan.planned_form(rows, lanes, H100) == form
        assert plan.planned_form(256, 256, None) is None
    pins(LBM_RESIDENT_INPLACE="1", LBM_RESIDENT_FORM="device")
    for limits in (H100, None):
        with pytest.raises(ValueError, match="single-buffer"):
            plan.planned_form(256, 256, limits)
    pins(LBM_RESIDENT_INPLACE="0", LBM_RESIDENT_FORM="device")
    assert plan.planned_form(256, 256, H100) == "device"
    pins(LBM_RESIDENT_FORM="onchip")
    for rows, lanes in [(256, 256), (64, 4096), (768, 768), (1024, 1024)]:
        assert plan.planned_form(rows, lanes, H100) == "onchip"
    pins(LBM_RESIDENT_FORM="onchip", LBM_RESIDENT_INPLACE="1")
    assert plan.planned_form(256, 256, H100) == "inplace"


def test_a_pinned_single_buffer_mode_keeps_the_cell_limit(pins):
    """LBM_RESIDENT_INPLACE=1 picks the mode, not residency: at 1024x1024
    (one buffer does not fit) the cell limit leaves the run to D=4, as the
    JAX package's resident_prefs leaves it to the blocked kernel; with
    LBM_RESIDENT=1 it plans the single-buffer mode all the same, so the
    wrapper raises on the card and never runs another form. At 1024x512,
    where the size rule takes one buffer, the pin plans what auto does."""
    pins(LBM_RESIDENT_INPLACE="1")
    form = plan.planned_form(1024, 1024, H100)
    assert form == "inplace"
    assert not plan.onchip_fits(1024, 1024, *H100, 1)
    assert plan.describe(plan.segments(1024, 1024, 200, form, H100)) == \
        "depth D=4 x50"
    assert plan.describe(plan.segments(
        1024, 512, 200, plan.planned_form(1024, 512, H100), H100)) == \
        "resident G=100 on-chip 1-buf x2"
    pins(LBM_RESIDENT_INPLACE="1", LBM_RESIDENT="1")
    assert plan.describe(plan.segments(1024, 1024, 200, form, H100)) == \
        "resident G=100 on-chip 1-buf x2"


@pytest.mark.parametrize("form", ["inplace", "onchip", "device", None])
def test_odd_g_pin_needs_the_single_buffer_form(pins, form):
    """An odd LBM_RESIDENT_STEPS is taken where the planned form is the
    single-buffer one (the JAX package's _pinned_steps(even=n_bufs == 2));
    elsewhere it raises and names the exception."""
    pins(LBM_RESIDENT="1", LBM_RESIDENT_STEPS="5")
    if form == "inplace":
        assert plan.resident_prefs(768, 768, form) == (5,)
        assert plan.describe(plan.segments(768, 768, 20, form)) == \
            "resident G=5 on-chip 1-buf x4"
        return
    with pytest.raises(ValueError, match="single-buffer"):
        plan.resident_prefs(768, 768, form)
    pins(LBM_RESIDENT="1", LBM_RESIDENT_STEPS="6")
    assert plan.resident_prefs(768, 768, form) == (6,)


def test_describe_names_the_single_buffer_mode(pins):
    seg = plan.Segment("resident", 100, 100, "inplace")
    assert seg.describe() == "resident G=100 on-chip 1-buf x1"
    assert seg.launch_key == "resident_onchip_inplace"
    assert plan.RESIDENT_FORMS == ("onchip", "inplace", "device", "shift")
    assert plan.FORM_PINS == ("onchip", "device")
    pins(LBM_RESIDENT_FORM="inplace")
    with pytest.raises(ValueError, match="LBM_RESIDENT_FORM"):
        plan.pinned_form()


# The device-memory form's shift mode ("shift"; LBM_RESIDENT_SHIFT).


def test_shift_pin_as_the_jax_package_reads_it(pins):
    """None unset, False for "0", "" or "false", True for anything else
    (``_pallas_resident``, where unset is off)."""
    assert plan.pinned_shift() is None
    for value, on in [("1", True), ("yes", True), ("0", False), ("", False),
                      ("false", False)]:
        pins(LBM_RESIDENT_SHIFT=value)
        assert plan.pinned_shift() is on


def test_shift_pin_plans_the_mode_in_row_layout_only(pins):
    """In row layout the pin plans the shift mode wherever the resident
    kernel runs, on chip-sized lattices too, on the card or off it; where
    the kernel has no shift mode (column layout, the ring) it does
    nothing, as in JAX."""
    pins(LBM_RESIDENT_SHIFT="1")
    for rows, lanes in [(256, 256), (64, 4096), (768, 768), (1024, 1024)]:
        for limits in (H100, None):
            assert plan.planned_form(rows, lanes, limits,
                                     shift_mode=True) == "shift"
        pins()
        unpinned = plan.planned_form(rows, lanes, H100)
        pins(LBM_RESIDENT_SHIFT="1")
        assert plan.planned_form(rows, lanes, H100) == unpinned
    assert plan.planned_form(256, 256, None) is None
    pins(LBM_RESIDENT_SHIFT="0")
    assert plan.planned_form(256, 256, H100, shift_mode=True) == "onchip"
    assert plan.planned_form(64, 4096, H100, shift_mode=True) == "device"
    assert plan.planned_form(64, 4096, None, shift_mode=True) is None


# Execution rows x lanes: auto's form in row layout on the H100 (the size
# rule's form where the shift rule does not apply).
@pytest.mark.parametrize("rows,lanes,form", [
    (64, 4096, "shift"),     # 4096x64: one-row strips, 19.1 MB
    (32, 8192, "shift"),     # 8192x32
    (100, 4100, "shift"),    # one-row strips, 29.9 MB, physical (4100 % 8)
    (132, 5000, "shift"),    # 48.2 MB, within the 50 MB L2
    (132, 5200, "device"),   # 50.1 MB: above it
    (140, 2800, "device"),   # strips of 2 rows that fit no buffer
    (1024, 1024, "device"),  # above the L2 (LBM_RESIDENT=1 runs it)
    (256, 256, "onchip"), (768, 768, "inplace")])
def test_auto_takes_the_shift_mode_for_narrow_channels_in_l2(pins, rows,
                                                              lanes, form):
    """Where the size rule sends a row-layout lattice to the device form
    because its strips would be one row, and both buffers and the mask fit
    the L2, auto takes the shift mode (measured 0.80-0.92x the device form
    at 4096x64 and 8192x32); nowhere else. Column layout and the ring never
    take it; off the card (no limits) nothing changes; LBM_RESIDENT_SHIFT=0
    and LBM_RESIDENT_FORM=device keep the default mode."""
    size_rule = plan.resident_form(rows, lanes, *H100)
    assert size_rule == ("device" if form == "shift" else form)
    assert plan.shift_auto(rows, lanes, H100[0]) == (
        rows <= H100[0] and 73 * rows * lanes <= 50e6)
    assert plan.planned_form(rows, lanes, H100, shift_mode=True) == form
    assert plan.planned_form(rows, lanes, H100) == size_rule
    assert plan.planned_form(rows, lanes, None, shift_mode=True) is None
    for pin in ({"LBM_RESIDENT_SHIFT": "0"},
                {"LBM_RESIDENT_FORM": "device"}):
        pins(**pin)
        want = "device" if form == "shift" else plan.planned_form(
            rows, lanes, H100)
        assert plan.planned_form(rows, lanes, H100, shift_mode=True) == want


def test_shift_pin_conflicts_raise(pins):
    """The shift mode is the device-memory form's: beside a pin of the
    on-chip form (LBM_RESIDENT_FORM=onchip, LBM_RESIDENT_INPLACE=1 or 0)
    it raises, on the card or off it, and under LBM_RESIDENT=0 as well;
    beside LBM_RESIDENT_FORM=device it plans the mode. In column layout the
    pin does nothing, so the other pin holds."""
    for other, resident in [({"LBM_RESIDENT_FORM": "onchip"}, {}),
                            ({"LBM_RESIDENT_INPLACE": "1"}, {}),
                            ({"LBM_RESIDENT_INPLACE": "0"}, {}),
                            ({"LBM_RESIDENT_INPLACE": "1"},
                             {"LBM_RESIDENT": "0"}),
                            ({"LBM_RESIDENT_FORM": "onchip"},
                             {"LBM_RESIDENT": "1"})]:
        pins(LBM_RESIDENT_SHIFT="1", **other, **resident)
        for limits in (H100, None):
            with pytest.raises(ValueError, match="LBM_RESIDENT_SHIFT"):
                plan.planned_form(256, 256, limits, shift_mode=True)
        assert plan.planned_form(256, 256, H100) == \
            ("onchip" if other.get("LBM_RESIDENT_INPLACE") != "1"
             else "inplace")
    pins(LBM_RESIDENT_SHIFT="1", LBM_RESIDENT_FORM="device")
    assert plan.planned_form(256, 256, H100, shift_mode=True) == "shift"
    assert plan.planned_form(256, 256, H100) == "device"


def test_shift_pin_never_lifts_the_cell_limit(pins):
    """The pin picks the mode, not residency: above RESIDENT_AUTO_MAX_CELLS
    the run stays on D=4 unless LBM_RESIDENT=1; LBM_RESIDENT=0 leaves no
    resident segment; the mode steps in pairs, so an odd
    LBM_RESIDENT_STEPS raises."""
    pins(LBM_RESIDENT_SHIFT="1")
    form = plan.planned_form(1024, 1024, H100, shift_mode=True)
    assert plan.describe(plan.segments(1024, 1024, 200, form, H100)) == \
        "depth D=4 x50"
    assert plan.describe(plan.segments(256, 256, 200, "shift", H100)) == \
        "resident G=100 device-memory shift x2"
    pins(LBM_RESIDENT_SHIFT="1", LBM_RESIDENT="1")
    assert plan.describe(plan.segments(1024, 1024, 200, form, H100)) == \
        "resident G=100 device-memory shift x2"
    pins(LBM_RESIDENT_SHIFT="1", LBM_RESIDENT="0")
    assert plan.describe(plan.segments(256, 256, 200, "shift", H100)) == \
        "depth D=4 x50"
    pins(LBM_RESIDENT_SHIFT="1", LBM_RESIDENT="1", LBM_RESIDENT_STEPS="5")
    with pytest.raises(ValueError, match="even"):
        plan.resident_prefs(256, 256, "shift")


def test_shift_pin_through_the_runner_follows_the_layout(pins):
    """Through ``runner.plan_run``: a physical lattice plans the mode, the
    transposed 1024x400 (column mode) does not; the plan line names it."""
    pins(LBM_RESIDENT_SHIFT="1")
    p, _ = _scene(200)
    parts = trunner.plan_run(p, "cuda", 200)
    assert [s.form for s in parts] == ["shift"]
    assert plan.describe(parts) == "resident G=100 device-memory shift x2"
    assert parts[0].launch_key == "resident_shift"
    wide = Params(nx=1024, ny=400, max_iters=200, reynolds_dim=10,
                  density=0.1, accel=0.005, omega=1.85)
    assert plan.layout(wide)[0]
    assert plan.describe(trunner.plan_run(wide, "cuda", 200)) == \
        "resident G=100 x2"
    assert plan.describe(trunner.plan_run(p, "cuda", 200, transposed=True)) \
        == "resident G=100 x2"


def test_shift_pin_leaves_the_ring_alone(pins):
    """JAX's ring has no shift mode: under the pin the ring's form is what
    it is without it."""
    from lbm_tpu_torch.parallel import resident_ring

    want = {shape: resident_ring.ring_form(*shape, 4, *H100)
            for shape in [(64, 256), (192, 768), (256, 1024)]}
    pins(LBM_RESIDENT_SHIFT="1")
    for shape, form in want.items():
        assert resident_ring.ring_form(*shape, 4, *H100) == form


def test_describe_names_the_shift_mode(pins):
    seg = plan.Segment("resident", 100, 20000, "shift")
    assert seg.describe() == "resident G=100 device-memory shift x200"
    assert seg.launch_key == "resident_shift"


# The depth kernel's flow form: rounds of D = 4 a launch, taken by the
# launch's length in waves of the card's block slots.
H100_DEPTH_SLOTS = 2 * 132  # two one-round depth blocks an SM


def _flow_on_cpu(monkeypatch, slots=H100_DEPTH_SLOTS):
    """The planned ``cuda`` path on CPU tensors, every wrapper's plain
    version, planned as on a card of ``slots`` depth-kernel slots."""
    from lbm_tpu_torch.ops import fused_depth, resident

    monkeypatch.setattr(trunner, "_resolve_kernel", lambda k, p, d: k)
    monkeypatch.setattr(resident, "_limits", lambda device: H100)
    monkeypatch.setattr(fused_depth, "block_slots",
                        lambda device, axis=0: slots)


@pytest.mark.parametrize("rows,lanes,axis,rounds", [
    (1024, 1024, 0, 25),     # 1376 tiles: 5.2 waves
    (1280, 1024, 0, 25),     # 6.5 waves, row mode
    (1536, 1024, 0, 1),      # 7.8 waves, row mode
    (2048, 1024, 0, 1),      # 10.4 waves, row mode
    (2048, 1024, 1, 25),     # the transposed 2048x1024: 10.4 waves
    (4096, 1024, 1, 1),      # 20.7 waves
    (16384, 1024, 1, 1),     # the transposed stress scene: 82.8 waves
    (64, 64, 0, 25), (64, 64, 1, 25)], ids=lambda v: str(v))
def test_flow_rounds_follow_a_launchs_waves(pins, rows, lanes, axis, rounds):
    """FLOW_STEPS steps a launch (D = 4 rounds) where a one-round launch
    is shorter than its forcing mode's FLOW_MAX_WAVES waves of the slots
    (fewer in row mode, whose flow kernel costs more a tile), one round
    where it is longer and off the card."""
    from lbm_tpu_torch.ops import fused_depth

    pins(LBM_RESIDENT="0")
    waves = fused_depth.n_tiles(rows, lanes, 4) / H100_DEPTH_SLOTS
    assert plan.FLOW_MAX_WAVES[0] < plan.FLOW_MAX_WAVES[1]
    assert (waves < plan.FLOW_MAX_WAVES[axis]) == (rounds > 1)
    assert plan.flow_rounds(rows, lanes, H100_DEPTH_SLOTS, axis) == rounds
    assert plan.FLOW_STEPS == 4 * 25
    assert plan.flow_rounds(rows, lanes, None, axis) == 1
    segs = plan.segments(rows, lanes, 20000, slots=H100_DEPTH_SLOTS,
                         axis=axis)
    assert segs == [plan.Segment("depth", 4 * rounds, 20000, rounds=rounds)]
    assert plan.describe(segs) == (
        "depth D=4 K=25 x200" if rounds > 1 else "depth D=4 x5000")


@pytest.mark.parametrize("env", [{}, {"LBM_RESIDENT": "0"},
                                 {"LBM_RESIDENT": "0", "LBM_PALLAS_DEPTH": "8"},
                                 {"LBM_RESIDENT": "1"}],
                         ids=["auto", "no-resident", "depth-8", "resident"])
def test_flow_segments_cover_the_run_and_divide_their_calls(pins, env):
    """With the flow form every plan still sums to the run and divides
    each segment's steps by its steps a call, which are D times its
    rounds; only D = 4 segments take more than one round, at most
    FLOW_STEPS / 4, and a D = 2 tail keeps one."""
    pins(**env)
    for iters in [*range(1, 230), 1099, 2002, 3002, 20000, 20001, 39999]:
        parts = plan.segments(1024, 1024, iters, slots=H100_DEPTH_SLOTS)
        assert sum(s.steps for s in parts) == iters
        for s in parts:
            assert s.steps > 0 and s.steps % s.steps_per_call == 0
            assert s.rounds == 1 or (
                s.kernel == "depth" and s.steps_per_call == 4 * s.rounds
                and s.rounds <= plan.FLOW_STEPS // 4)
            if s.kernel == "depth" and s.steps_per_call % 4:
                assert s.rounds == 1
        # The whole launches first, then at most one of fewer rounds.
        flows = [s for s in parts if s.rounds > 1]
        assert len(flows) <= 2 and all(
            s.launches == 1 for s in flows[1:])
    assert plan.describe(plan.segments(
        1024, 1024, 20002, slots=H100_DEPTH_SLOTS)) == (
        "resident G=100 x200, depth D=2 x1" if env == {"LBM_RESIDENT": "1"}
        else "depth D=8 x2500, depth D=2 x1" if "LBM_PALLAS_DEPTH" in env
        else "depth D=4 K=25 x200, depth D=2 x1")
    if not env:
        assert plan.describe(plan.segments(
            1024, 1024, 20096, slots=H100_DEPTH_SLOTS)) == \
            "depth D=4 K=25 x200, depth D=4 K=24 x1"


def test_seam_and_sharded_plans_keep_one_round(pins):
    """The sharded planner (the seam modes, whose halos are refilled at
    every launch, and the ring) and the unsharded planner off the card
    plan one round a launch."""
    pins(LBM_RESIDENT="0")
    for iters in (200, 3002, 20000):
        for parts in (plan.plan_segments(iters, None, [4, 2]),
                      plan.segments(1024, 1024, iters)):
            assert all(s.rounds == 1 for s in parts)
    assert plan.flow_segments(plan.plan_segments(202, None, [4, 2]), 1) == \
        plan.plan_segments(202, None, [4, 2])


@pytest.mark.parametrize("stride", [3002, 70, 42, 6])
def test_a_chunk_boundary_falls_on_a_round_boundary(pins, stride):
    """Each chunk length is planned on its own, so every chunk ends a
    launch, and so a round: its segments sum to the chunk and divide by
    their steps a call."""
    pins(LBM_RESIDENT="0")
    for n in trunner.chunk_sizes(0, 20000, stride):
        parts = plan.segments(1024, 1024, n, slots=H100_DEPTH_SLOTS)
        assert sum(s.steps for s in parts) == n
        assert all(s.steps % s.steps_per_call == 0 for s in parts)
        assert any(s.rounds > 1 for s in parts) == (n >= 8)


def test_a_flow_run_equals_the_one_round_run_chunked_or_not(pins,
                                                            monkeypatch):
    """On CPU tensors planned as on a card: 240 steps under the flow form
    (K=25, then a launch of fewer rounds and a D=2 tail), uncut and in
    chunks of 70, give the one-round plan's cells and trajectory bit for
    bit, and the run records its flowing tiles and no waits."""
    pins(LBM_RESIDENT="0")
    p, mask = _scene(242)
    one = trunner.run_simulation(p, mask.numpy(), kernel="reference",
                                 device="cpu")
    _flow_on_cpu(monkeypatch)
    assert plan.describe(trunner.plan_run(p, "cuda", 242, device="cpu")) == \
        "depth D=4 K=25 x2, depth D=4 K=10 x1, depth D=2 x1"
    flow = trunner.run_simulation(p, mask.numpy(), kernel="cuda",
                                  device="cpu")
    chunked = trunner.run_simulation(p, mask.numpy(), kernel="cuda",
                                     device="cpu", chunk_iters=70)
    for run in (flow, chunked):
        np.testing.assert_array_equal(run.cells, one.cells)
        np.testing.assert_array_equal(run.av_vels, one.av_vels)
    tiles = 2 * 2  # 40 rows and 48 columns of 24 x 32 tiles
    t = flow.timings
    assert t["compute.depth.flow_tiles"] == (2 * 24 + 9) * tiles
    assert t["compute.depth.waits"] == 0
    # chunks of 70: 68 steps at D = 4 (17 rounds) and a D = 2 tail, three
    # times, then 32 steps (8 rounds).
    assert chunked.timings["compute.depth.flow_tiles"] == \
        (3 * 16 + 7) * tiles
    # A run of one round, a single launch, records neither.
    assert "compute.depth.flow_tiles" not in trunner.run_simulation(
        p, mask.numpy(), kernel="cuda", device="cpu", n_iters=4).timings
