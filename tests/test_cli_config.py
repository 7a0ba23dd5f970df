"""Config system + CLI driver (C18)."""

import json
import os

import numpy as np
import pytest

from spectrobot_tpu.config import Config, apply_overrides, load_config


def test_defaults_load():
    cfg = load_config(None)
    assert cfg.grid.n_points == 4096
    assert cfg.scene.species == ("CO2",)


def test_toml_and_overrides(tmp_path):
    p = tmp_path / "cfg.toml"
    p.write_text("""
[grid]
nu_min = 650.0
nu_max = 690.0
n_points = 512
[scene]
species = ["CO2", "CO"]
n_levels = 9
[geometry]
tangent_heights_km = [10.0, 30.0]
""")
    cfg = load_config(str(p), {"grid.n_points": "1024",
                               "compute.variant": "weideman"})
    assert cfg.grid.nu_min == 650.0
    assert cfg.grid.n_points == 1024
    assert cfg.scene.species == ("CO2", "CO")
    assert cfg.compute.variant == "weideman"


def test_unknown_key_rejected(tmp_path):
    p = tmp_path / "bad.toml"
    p.write_text("[grid]\nnot_a_key = 3\n")
    with pytest.raises(KeyError):
        load_config(str(p))
    with pytest.raises(AttributeError):
        apply_overrides(Config(), {"grid.nope": 1})


def test_cli_forward_runs(tmp_path, capsys):
    from spectrobot_tpu.cli import main
    cfg = tmp_path / "c.toml"
    cfg.write_text(f"""
[grid]
nu_min = 660.0
nu_max = 674.0
n_points = 256
[scene]
n_levels = 7
z_top_m = 60e3
[geometry]
tangent_heights_km = [10.0, 30.0]
n_sub = 2
[compute]
dtype = "float64"
chunk = 128
[run]
output_dir = "{tmp_path}/out"
""")
    rc = main(["forward", str(cfg)])
    assert rc == 0
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert payload["radiance_shape"] == [2, 256]
    with np.load(os.path.join(str(tmp_path), "out", "forward.npz")) as z:
        I = z["radiance"]
    assert I.shape == (2, 256) and np.isfinite(I).all() and (I > 0).all()


def test_cli_retrieve_selftest(tmp_path, capsys):
    from spectrobot_tpu.cli import main
    cfg = tmp_path / "c.toml"
    cfg.write_text(f"""
[grid]
nu_min = 660.0
nu_max = 674.0
n_points = 160
[scene]
n_levels = 6
z_top_m = 60e3
[geometry]
tangent_heights_km = [8.0, 25.0]
n_sub = 2
[instrument]
enabled = true
fwhm_cm1 = 0.4
n_channels = 40
[compute]
dtype = "float64"
chunk = 128
[retrieval]
max_iter = 8
[run]
output_dir = "{tmp_path}/out"
""")
    rc = main(["retrieve", str(cfg)])
    assert rc == 0
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert payload["converged"] is True
    assert os.path.exists(os.path.join(str(tmp_path), "out", "run.jsonl"))
    assert os.path.exists(os.path.join(str(tmp_path), "out", "retrieval.npz"))


def test_cli_forward_mesh(tmp_path, capsys):
    # Sharded forward through the CLI on the 8-device emulated mesh.
    from spectrobot_tpu.cli import main
    cfg = tmp_path / "m.toml"
    cfg.write_text(f"""
[grid]
nu_min = 660.0
nu_max = 674.0
n_points = 256
[scene]
n_levels = 7
z_top_m = 60e3
[geometry]
tangent_heights_km = [10.0, 30.0]
n_sub = 2
[compute]
dtype = "float64"
chunk = 128
mesh_ray = 2
mesh_line = 2
mesh_nu = 2
[run]
output_dir = "{tmp_path}/out_mesh"
""")
    rc = main(["forward", str(cfg)])
    assert rc == 0
    import json as _json
    payload = _json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert payload["radiance_shape"] == [2, 256]
    with np.load(os.path.join(str(tmp_path), "out_mesh", "forward.npz")) as z:
        I_mesh = z["radiance"]
    # Parity with the single-device CLI run.
    cfg2 = tmp_path / "s.toml"
    cfg2.write_text(cfg.read_text().replace("mesh_ray = 2", "mesh_ray = 1")
                    .replace("mesh_line = 2", "mesh_line = 1")
                    .replace("mesh_nu = 2", "mesh_nu = 1")
                    .replace("out_mesh", "out_single"))
    assert main(["forward", str(cfg2)]) == 0
    capsys.readouterr()
    with np.load(os.path.join(str(tmp_path), "out_single", "forward.npz")) as z:
        I_single = z["radiance"]
    np.testing.assert_allclose(I_mesh, I_single, rtol=1e-10)


def test_bool_and_optional_overrides():
    # Review findings: bool('false') was True; None-default stayed str.
    cfg = load_config(None, {"compute.use_pallas": "false"})
    assert cfg.compute.use_pallas is False
    cfg = load_config(None, {"compute.use_pallas": "true"})
    assert cfg.compute.use_pallas is True
    with pytest.raises(ValueError):
        load_config(None, {"compute.use_pallas": "maybe"})
    cfg = load_config(None, {"lines.min_sw": "1e-25"})
    assert isinstance(cfg.lines.min_sw, float) and cfg.lines.min_sw == 1e-25


def test_default_config_nadir_runs_on_multidevice_host(tmp_path, capsys):
    # Regression: the auto-expanded mesh default must NOT engage the mesh
    # path (this suite runs with 8 emulated devices, like a multi-chip
    # host); untouched configs run single-device in any geometry.
    from spectrobot_tpu.cli import main
    cfg = tmp_path / "n.toml"
    cfg.write_text(f"""
[grid]
nu_min = 660.0
nu_max = 674.0
n_points = 128
[scene]
n_levels = 6
z_top_m = 60e3
[geometry]
mode = "nadir"
n_sub = 2
[compute]
dtype = "float64"
chunk = 64
[run]
output_dir = "{tmp_path}/out_nadir"
""")
    assert main(["forward", str(cfg)]) == 0
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert payload["radiance_shape"] == [1, 128]


def test_cli_forward_lut_runtime(tmp_path, capsys):
    # The C9 LUT runtime through the CLI, vs the direct line-sum run.
    from spectrobot_tpu.cli import main
    base = f"""
[grid]
nu_min = 660.0
nu_max = 674.0
n_points = 200
[scene]
n_levels = 7
z_top_m = 60e3
[geometry]
tangent_heights_km = [10.0, 30.0]
n_sub = 2
[compute]
dtype = "float64"
chunk = 128
"""
    cfg1 = tmp_path / "lut.toml"
    cfg1.write_text(base + f"use_lut = true\n[run]\noutput_dir = \"{tmp_path}/o1\"\n")
    cfg2 = tmp_path / "direct.toml"
    cfg2.write_text(base + f"[run]\noutput_dir = \"{tmp_path}/o2\"\n")
    assert main(["forward", str(cfg1)]) == 0
    assert main(["forward", str(cfg2)]) == 0
    capsys.readouterr()
    with np.load(os.path.join(str(tmp_path), "o1", "forward.npz")) as z:
        I_lut = z["radiance"]
    with np.load(os.path.join(str(tmp_path), "o2", "forward.npz")) as z:
        I_dir = z["radiance"]
    # LUT interpolation error budget (~<2%) on top of identical physics.
    denom = np.maximum(I_dir, I_dir.max() * 1e-3)
    assert np.max(np.abs(I_lut - I_dir) / denom) < 0.05


_NLTE_BASE = """
[grid]
nu_min = 2320.0
nu_max = 2360.0
n_points = 300
[lines]
source = "synthetic:co2_43um,co2_43um_hot"
[scene]
n_levels = 10
z_top_m = 90e3
[geometry]
tangent_heights_km = [40.0, 65.0]
n_sub = 2
[compute]
dtype = "float64"
chunk = 128
"""


def test_cli_forward_nlte(tmp_path, capsys):
    """Non-LTE through the driver (reference call stack 4.4): the demo
    pumping brightens the 4.3 um limb vs the LTE run."""
    from spectrobot_tpu.cli import main
    cfg_lte = tmp_path / "lte.toml"
    cfg_lte.write_text(_NLTE_BASE + f"[run]\noutput_dir = \"{tmp_path}/lte\"\n")
    cfg_nl = tmp_path / "nlte.toml"
    cfg_nl.write_text(_NLTE_BASE + f"""
[nlte]
enabled = true
t_vib = "demo:co2_pump"
[run]
output_dir = "{tmp_path}/nlte"
""")
    assert main(["forward", str(cfg_lte)]) == 0
    assert main(["forward", str(cfg_nl)]) == 0
    capsys.readouterr()
    with np.load(os.path.join(str(tmp_path), "lte", "forward.npz")) as z:
        I_lte = z["radiance"]
    with np.load(os.path.join(str(tmp_path), "nlte", "forward.npz")) as z:
        I_nl = z["radiance"]
    assert np.isfinite(I_nl).all()
    # Pumped nu3 populations must brighten the high tangent ray materially.
    assert I_nl[1].max() > 1.05 * I_lte[1].max()


def test_cli_forward_nlte_tvib_file_and_lut(tmp_path, capsys):
    """t_vib from a .npz profile file, through BOTH the direct path and the
    non-LTE LUT runtime — the two agree to interpolation error."""
    import numpy as np
    from spectrobot_tpu.cli import main
    from spectrobot_tpu.data.nlte import save_t_vib_npz

    z = np.linspace(0.0, 90e3, 10)
    t_kin = np.linspace(210.0, 150.0, 10)
    tv = t_kin[None, :] * np.array([[1.0], [1.3]])
    tv_path = str(tmp_path / "tvib.npz")
    save_t_vib_npz(tv_path, z, ["2:1:0001", "2:1:0111"], tv)

    block = _NLTE_BASE + f"""
[nlte]
enabled = true
t_vib = "{tv_path}"
"""
    cfg_d = tmp_path / "direct.toml"
    cfg_d.write_text(block + f"[run]\noutput_dir = \"{tmp_path}/d\"\n")
    cfg_l = tmp_path / "lut.toml"
    cfg_l.write_text(block + f"""
[run]
output_dir = "{tmp_path}/l"
""")
    assert main(["forward", str(cfg_d)]) == 0
    assert main(["forward", str(cfg_l), "-o", "compute.use_lut=true"]) == 0
    capsys.readouterr()
    with np.load(os.path.join(str(tmp_path), "d", "forward.npz")) as zz:
        I_d = zz["radiance"]
    with np.load(os.path.join(str(tmp_path), "l", "forward.npz")) as zz:
        I_l = zz["radiance"]
    denom = np.maximum(I_d, I_d.max() * 1e-3)
    assert np.max(np.abs(I_l - I_d) / denom) < 0.05


def test_cli_retrieve_nlte(tmp_path, capsys):
    """Self-test retrieval THROUGH a non-LTE forward model converges."""
    from spectrobot_tpu.cli import main
    cfg = tmp_path / "r.toml"
    cfg.write_text(_NLTE_BASE + f"""
[nlte]
enabled = true
t_vib = "demo:co2_pump"
[retrieval]
max_iter = 8
[run]
output_dir = "{tmp_path}/ret"
""")
    assert main(["retrieve", str(cfg)]) == 0
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert payload["converged"]


def test_cli_retrieve_vmr_only(tmp_path, capsys):
    """VMR-only retrieval (retrieve_temperature = false): the reference's
    bayes sets switch T and VMR independently."""
    from spectrobot_tpu.cli import main
    cfg = tmp_path / "v.toml"
    cfg.write_text(f"""
[grid]
nu_min = 660.0
nu_max = 674.0
n_points = 256
[scene]
n_levels = 7
z_top_m = 60e3
[geometry]
tangent_heights_km = [8.0, 25.0]
n_sub = 2
[compute]
dtype = "float64"
chunk = 128
[retrieval]
retrieve_temperature = false
retrieve_vmr = ["CO2"]
max_iter = 8
[run]
output_dir = "{tmp_path}/ret"
""")
    assert main(["retrieve", str(cfg)]) == 0
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert payload["converged"]
    with np.load(os.path.join(str(tmp_path), "ret", "retrieval.npz")) as z:
        x = z["x"]
    # State is the CO2 ln-VMR profile only (7 levels, no T block).
    assert x.shape == (7,)
    # Retrieved ln VMR moved toward the perturbed truth (nonzero update).
    assert np.max(np.abs(x - np.log(0.9532))) > 0.05


def test_cli_retrieve_nothing_rejected(tmp_path):
    from spectrobot_tpu.cli import main
    import pytest
    cfg = tmp_path / "n.toml"
    cfg.write_text("""
[retrieval]
retrieve_temperature = false
""")
    with pytest.raises(ValueError, match="nothing to retrieve"):
        main(["retrieve", str(cfg)])


def test_cli_retrieve_from_obs_table(tmp_path, capsys):
    """End-to-end round-1 review item 8: forward -> dump a campaign-style
    text table -> retrieve from that file through retrieval.obs_path."""
    import numpy as np
    from spectrobot_tpu.cli import main
    from spectrobot_tpu.retrieval.obs import Observation

    base = f"""
[grid]
nu_min = 660.0
nu_max = 674.0
n_points = 160
[scene]
n_levels = 6
z_top_m = 60e3
[geometry]
tangent_heights_km = [8.0, 25.0]
n_sub = 2
[instrument]
enabled = true
fwhm_cm1 = 0.4
n_channels = 40
[compute]
dtype = "float64"
chunk = 128
[retrieval]
max_iter = 8
obs_path = "{tmp_path}/obs.txt"
[run]
output_dir = "{tmp_path}/out"
"""
    cfg = tmp_path / "c.toml"
    cfg.write_text(base)
    # Synthesise the "campaign file" from a perturbed-truth forward run.
    rc = main(["forward", str(cfg), "-o", "scene.n_levels=6"])
    assert rc == 0
    fwd = np.load(str(tmp_path / "out" / "forward.npz"))
    nu_chan = np.linspace(660.0 + 2 * 0.4, 674.0 - 2 * 0.4, 40)
    rng = np.random.default_rng(1)
    y = fwd["radiance"] * (1.0 + 0.02 * rng.standard_normal(
        fwd["radiance"].shape))
    obs = Observation(
        y=y, sigma=np.full_like(y, 0.01 * float(y.max())),
        mask=np.ones(y.shape, dtype=bool), nu_channels=nu_chan,
        tangent_heights_m=np.array([8e3, 25e3]))
    obs.save_table(str(tmp_path / "obs.txt"))

    rc = main(["retrieve", str(cfg)])
    assert rc == 0
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert payload["converged"] is True

    # A mismatched geometry in the config fails LOUDLY, naming the key.
    import pytest
    with pytest.raises(ValueError, match="tangent_heights_km"):
        main(["retrieve", str(cfg), "-o",
              "geometry.tangent_heights_km=8.0,30.0"])


_TINY = """
[grid]
nu_min = 660.0
nu_max = 674.0
n_points = 160
[scene]
n_levels = 6
z_top_m = 60e3
[geometry]
tangent_heights_km = [8.0, 25.0]
n_sub = 2
[instrument]
enabled = true
fwhm_cm1 = 0.4
n_channels = 40
[compute]
dtype = "float64"
chunk = 128
[retrieval]
max_iter = 8
"""


def test_cli_retrieve_lut_runtime(tmp_path, capsys):
    """compute.use_lut must be honoured by cmd_retrieve (round-2 review
    item 4): the LUT retrieval converges and lands within LUT interpolation
    error of the direct line-by-line retrieval."""
    from spectrobot_tpu.cli import main

    c_lut = tmp_path / "lut.toml"
    c_lut.write_text(_TINY.replace("chunk = 128",
                                   "chunk = 128\nuse_lut = true")
                     + f"[run]\noutput_dir = \"{tmp_path}/r_lut\"\n")
    c_dir = tmp_path / "dir.toml"
    c_dir.write_text(_TINY + f"[run]\noutput_dir = \"{tmp_path}/r_dir\"\n")

    assert main(["retrieve", str(c_lut)]) == 0
    out_lut = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert main(["retrieve", str(c_dir)]) == 0
    out_dir = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out_lut["converged"] and out_dir["converged"]
    with np.load(f"{tmp_path}/r_lut/retrieval.npz") as z:
        x_lut = z["x"]
    with np.load(f"{tmp_path}/r_dir/retrieval.npz") as z:
        x_dir = z["x"]
    # Temperatures within ~1 K of each other (LUT accuracy, self-test noise
    # realisation shared since both synthesize with seed=0).
    np.testing.assert_allclose(x_lut[:6], x_dir[:6], atol=1.5)


def test_cli_mesh_lut_runtime(tmp_path, capsys):
    """mesh x LUT (the last feature-matrix cell): the sharded LUT forward
    matches the single-device LUT forward, and a mesh LUT retrieval
    converges."""
    from spectrobot_tpu.cli import main
    base = _TINY.replace("chunk = 128", "chunk = 128\nuse_lut = true")
    c_mesh = tmp_path / "ml.toml"
    c_mesh.write_text(base.replace("use_lut = true",
                                   "use_lut = true\nmesh_ray = 2\nmesh_nu = 4")
                      + f"[run]\noutput_dir = \"{tmp_path}/ml\"\n")
    c_single = tmp_path / "sl.toml"
    c_single.write_text(base + f"[run]\noutput_dir = \"{tmp_path}/sl\"\n")
    assert main(["forward", str(c_mesh)]) == 0
    assert main(["forward", str(c_single)]) == 0
    capsys.readouterr()
    with np.load(f"{tmp_path}/ml/forward.npz") as z:
        I_m = z["radiance"]
    with np.load(f"{tmp_path}/sl/forward.npz") as z:
        I_s = z["radiance"]
    np.testing.assert_allclose(I_m, I_s, rtol=1e-10)

    assert main(["retrieve", str(c_mesh)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["converged"] is True


def test_cli_forward_nadir_mesh(tmp_path, capsys):
    """Nadir x mesh through the CLI (round-2 review item 8)."""
    from spectrobot_tpu.cli import main
    base = f"""
[grid]
nu_min = 660.0
nu_max = 674.0
n_points = 256
[scene]
n_levels = 6
z_top_m = 60e3
[geometry]
mode = "nadir"
sec_theta = [1.0, 1.3]
emissivity = 0.9
n_sub = 2
[compute]
dtype = "float64"
chunk = 128
"""
    c_mesh = tmp_path / "nm.toml"
    c_mesh.write_text(base + "mesh_ray = 2\nmesh_line = 2\nmesh_nu = 2\n"
                      + f"[run]\noutput_dir = \"{tmp_path}/nm\"\n")
    c_single = tmp_path / "ns.toml"
    c_single.write_text(base + f"[run]\noutput_dir = \"{tmp_path}/ns\"\n")
    assert main(["forward", str(c_mesh)]) == 0
    assert main(["forward", str(c_single)]) == 0
    capsys.readouterr()
    with np.load(f"{tmp_path}/nm/forward.npz") as z:
        I_m = z["radiance"]
    with np.load(f"{tmp_path}/ns/forward.npz") as z:
        I_s = z["radiance"]
    np.testing.assert_allclose(I_m, I_s, rtol=1e-10)


def test_cli_mesh_halo_parity(tmp_path, capsys):
    """compute.mesh_halo (nu-halo line distribution) matches the line-psum
    mesh through the CLI.  Grid span 14 cm-1 over mesh_nu=2 -> shard width
    7; cutoff set to 6 to satisfy the exactness guard."""
    from spectrobot_tpu.cli import main
    base = f"""
[grid]
nu_min = 660.0
nu_max = 674.0
n_points = 256
[scene]
n_levels = 6
z_top_m = 60e3
[geometry]
tangent_heights_km = [10.0, 30.0]
n_sub = 2
[compute]
dtype = "float64"
chunk = 128
cutoff_cm1 = 6.0
mesh_ray = 2
mesh_line = 2
mesh_nu = 2
"""
    c_halo = tmp_path / "h.toml"
    c_halo.write_text(base + "mesh_halo = true\n"
                      + f"[run]\noutput_dir = \"{tmp_path}/h\"\n")
    c_psum = tmp_path / "p.toml"
    c_psum.write_text(base + f"[run]\noutput_dir = \"{tmp_path}/p\"\n")
    assert main(["forward", str(c_halo)]) == 0
    assert main(["forward", str(c_psum)]) == 0
    capsys.readouterr()
    with np.load(f"{tmp_path}/h/forward.npz") as z:
        I_h = z["radiance"]
    with np.load(f"{tmp_path}/p/forward.npz") as z:
        I_p = z["radiance"]
    np.testing.assert_allclose(I_h, I_p, rtol=1e-10)


def test_cli_fov_retrieval(tmp_path, capsys):
    """[instrument] FOV smearing reachable from the config (the review
    round-2 item 7): forward shape is per OBSERVED ray, and a config-driven
    limb retrieval with FOV converges on the emulated mesh."""
    from spectrobot_tpu.cli import main
    base = _TINY.replace("n_channels = 40",
                         "n_channels = 40\nfov_fwhm_km = 4.0\nfov_n_fine = 8")
    c = tmp_path / "fov.toml"
    c.write_text(base + f"[run]\noutput_dir = \"{tmp_path}/fov\"\n")
    assert main(["forward", str(c)]) == 0
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert payload["radiance_shape"] == [2, 40]      # observed rays, not 8

    c_mesh = tmp_path / "fovm.toml"
    c_mesh.write_text(base.replace("chunk = 128",
                                   "chunk = 128\nmesh_ray = 2\nmesh_line = 2"
                                   "\nmesh_nu = 2")
                      + f"[run]\noutput_dir = \"{tmp_path}/fovm\"\n")
    assert main(["retrieve", str(c_mesh)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["converged"] is True


def test_cli_stop_reason_reported(tmp_path, capsys):
    """Honest convergence reporting (round-2 review weak item 7): a
    max_iter-limited run says so instead of a bare converged: false."""
    from spectrobot_tpu.cli import main
    c = tmp_path / "mi.toml"
    c.write_text(_TINY.replace("max_iter = 8", "max_iter = 1")
                 + f"[run]\noutput_dir = \"{tmp_path}/mi\"\n")
    assert main(["retrieve", str(c)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["converged"] is False
    assert out["stop_reason"] == "max_iter"
    assert "max_iter" in out["status"]
    with np.load(f"{tmp_path}/mi/retrieval.npz") as z:
        assert str(z["stop_reason"]) == "max_iter"


def test_no_silently_ignored_config_flags():
    """Tripwire (round-2 review weak item 1): every config key must at
    least be REFERENCED by the driver layer — a key that appears nowhere in
    cli.py/config consumers is a silent no-op waiting to happen.  (This
    cannot prove semantic honouring, but catches dropped wiring like the
    round-2 `use_lut`-ignored-in-retrieve bug.)"""
    import dataclasses
    import os

    import spectrobot_tpu.cli as cli_mod
    from spectrobot_tpu import config as config_mod

    src = open(cli_mod.__file__).read()
    # Keys consumed by the scene/obs builders inside cli.py or by modules it
    # delegates to explicitly (checked by name below).
    for section in dataclasses.fields(config_mod.Config):
        for f in dataclasses.fields(section.type if not isinstance(
                section.type, str) else getattr(config_mod, section.type)):
            key = f.name
            assert key in src, (
                f"config key [{section.name}] {key} is never referenced in "
                f"cli.py — either wire it or fail loudly on use")


def test_one_engine_policy_across_subcommands(tmp_path, monkeypatch, capsys):
    """ONE engine policy (round-3 review weak item 2 / next item 4): forward
    (single-device), forward (mesh), and retrieve must ALL route their
    opacity-engine choice through cli._engine with the same line count for
    the same config — no path may consult compute.use_pallas directly and
    silently take a different engine."""
    import spectrobot_tpu.cli as cli_mod

    calls = []
    real_engine = cli_mod._engine

    def recording_engine(cfg, n_lines):
        out = real_engine(cfg, n_lines)
        calls.append((n_lines, out))
        return out

    monkeypatch.setattr(cli_mod, "_engine", recording_engine)

    base = _TINY + f"[run]\noutput_dir = \"{tmp_path}/ep\"\n"
    c = tmp_path / "ep.toml"
    c.write_text(base)

    assert cli_mod.main(["forward", str(c)]) == 0
    n_fwd = len(calls)
    assert n_fwd >= 1, "single-device forward must consult _engine"

    assert cli_mod.main(["forward", str(c), "-o", "compute.mesh_nu=8"]) == 0
    n_mesh = len(calls)
    assert n_mesh > n_fwd, "mesh forward must consult _engine"

    assert cli_mod.main(["retrieve", str(c)]) == 0
    assert len(calls) > n_mesh, "retrieve must consult _engine"

    n_lines = {n for n, _ in calls}
    engines = {e for _, e in calls}
    assert len(n_lines) == 1, f"paths saw different line counts: {calls}"
    assert len(engines) == 1, f"paths chose different engines: {calls}"
    capsys.readouterr()


def test_cli_mesh_halo_too_narrow_fails_loudly(tmp_path):
    """A TOML-reachable mesh_halo config whose grid is narrower than
    mesh_nu * cutoff must raise a ValueError naming the config keys to
    change, not a bare AssertionError (round-3 review weak item 6)."""
    from spectrobot_tpu.cli import main
    c = tmp_path / "narrow.toml"
    c.write_text(_TINY + f"[run]\noutput_dir = \"{tmp_path}/nh\"\n")
    with pytest.raises(ValueError) as exc:
        main(["forward", str(c), "-o", "compute.mesh_nu=8",
              "-o", "compute.mesh_halo=true"])
    msg = str(exc.value)
    for key in ("compute.cutoff_cm1", "compute.mesh_nu", "grid.nu_min",
                "compute.mesh_halo"):
        assert key in msg, f"error must name {key}: {msg}"


def test_cli_mesh_divisibility_fails_loudly(tmp_path):
    """TOML-reachable mesh divisibility violations must raise ValueError
    naming the config keys (round-4 review weak item 2) — one standard with the
    halo guard — from every mesh subcommand branch."""
    from spectrobot_tpu.cli import main
    c = tmp_path / "div.toml"
    c.write_text(_TINY + f"[run]\noutput_dir = \"{tmp_path}/dv\"\n")
    # 2 rays on a 3-way ray mesh (plain mesh branch).
    with pytest.raises(ValueError) as exc:
        main(["forward", str(c), "-o", "compute.mesh_ray=3"])
    assert "compute.mesh_ray" in str(exc.value)
    assert "AssertionError" not in type(exc.value).__name__
    # 160 points on a 7-way nu mesh (forward + retrieve mesh branches).
    with pytest.raises(ValueError) as exc:
        main(["forward", str(c), "-o", "compute.mesh_nu=7"])
    assert "compute.mesh_nu" in str(exc.value)
    assert "grid.n_points" in str(exc.value)
    with pytest.raises(ValueError) as exc:
        main(["retrieve", str(c), "-o", "compute.mesh_nu=7"])
    assert "compute.mesh_nu" in str(exc.value)
    # LUT x mesh branch consults the same guard.
    with pytest.raises(ValueError) as exc:
        main(["forward", str(c), "-o", "compute.mesh_nu=7",
              "-o", "compute.use_lut=true"])
    assert "compute.mesh_nu" in str(exc.value)


def test_cli_forward_emits_spectrum_family(tmp_path, capsys):
    """forward.npz is written through the Spectrum family (round-3 review weak
    item 5): loads as a Spectrum with kind/units metadata, and the spectral
    axis is the INSTRUMENT CHANNEL grid when ILS is enabled (the old writer
    paired channelised radiances with the fine grid)."""
    from spectrobot_tpu.cli import main
    from spectrobot_tpu.spectra import Spectrum

    c = tmp_path / "sp.toml"
    c.write_text(_TINY + f"[run]\noutput_dir = \"{tmp_path}/sp\"\n")
    assert main(["forward", str(c)]) == 0
    capsys.readouterr()
    path = f"{tmp_path}/sp/forward.npz"
    sp = Spectrum.load_npz(path)
    assert sp.kind == "radiance"
    assert sp.units.startswith("W m^-2")
    # _TINY enables the instrument with 40 channels over a 160-pt grid.
    assert sp.values.shape == (2, 40)
    assert sp.nu.shape == (40,)                 # channel centers, not 160
    with np.load(path) as z:
        assert str(z["units"]) == sp.units
        np.testing.assert_array_equal(z["radiance"], np.asarray(sp.values))
        assert z["nu_fine"].shape == (160,)     # fine grid kept alongside
    # The Spectrum API consumes it: brightness temperature is finite and
    # physically sensible for a cold Mars limb.
    tb = sp.brightness_temperature()
    assert np.isfinite(np.asarray(tb.values)).all()
    assert float(np.asarray(tb.values).max()) < 400.0


def test_cli_retrieve_resumes_from_checkpoint(tmp_path, capsys):
    """Failure recovery THROUGH THE CLI (SURVEY.md section 6): a run cut
    off by the iteration budget leaves per-iteration checkpoints; simply
    re-running the same command resumes from the last accepted iteration
    instead of restarting, and converges."""
    from spectrobot_tpu.cli import main

    out = f"{tmp_path}/resume"
    c = tmp_path / "r.toml"
    c.write_text(_TINY.replace("max_iter = 8", "max_iter = 2")
                 + f"[run]\noutput_dir = \"{out}\"\n")
    assert main(["retrieve", str(c)]) == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert first["converged"] is False and first["stop_reason"] == "max_iter"
    import glob
    n_ck = len(glob.glob(f"{out}/ck/*.npz"))
    assert n_ck >= 1, "interrupted run must leave checkpoints"

    # Same command, bigger budget: resumes (iteration counter continues
    # past the checkpointed iterations) and converges.
    assert main(["retrieve", str(c), "-o", "retrieval.max_iter=8"]) == 0
    second = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert second["converged"] is True
    # run.jsonl records the resumed iterations with indices continuing
    # after the first run's (0-based: first run logged 0..1).
    iters = [json.loads(l)["iteration"]
             for l in open(f"{out}/run.jsonl") if "iteration" in l]
    assert max(iters) >= 2 and 0 in iters

    # A checkpoint from a DIFFERENT retrieval configuration must refuse to
    # resume with a loud ValueError naming the fix, not crash deep inside
    # unravel (round-5 verify found exactly this against a stale
    # checkpoint when retrieval.n_nodes changed the state size).
    with pytest.raises(ValueError, match="checkpoint"):
        main(["retrieve", str(c), "-o", "retrieval.n_nodes=3"])


def test_cli_forward_save_optics(tmp_path, capsys):
    """[run] save_optics writes the reference's SpectralObject-family
    optics (per-ray LOS optical depth + transmittance) from the SAME line
    sum as the radiance — and the radiance output is unchanged by the
    flag."""
    from spectrobot_tpu.cli import main
    from spectrobot_tpu.spectra import Spectrum

    base = _TINY + "[run]\n"
    c1 = tmp_path / "o1.toml"
    c1.write_text(base + f"output_dir = \"{tmp_path}/o1\"\nsave_optics = true\n")
    c2 = tmp_path / "o2.toml"
    c2.write_text(base + f"output_dir = \"{tmp_path}/o2\"\n")
    assert main(["forward", str(c1)]) == 0
    assert main(["forward", str(c2)]) == 0
    capsys.readouterr()

    sp = Spectrum.load_npz(f"{tmp_path}/o1/optics.npz")
    assert sp.kind == "optical_depth"
    tau = np.asarray(sp.values)
    assert tau.shape == (2, 160)        # per-ray, FINE grid (not channels)
    assert np.isfinite(tau).all() and (tau >= 0).all()
    # Low tangent ray is optically thicker than the high one at band center.
    assert tau[0].max() > tau[1].max()
    with np.load(f"{tmp_path}/o1/optics.npz") as z:
        np.testing.assert_allclose(z["transmittance"], np.exp(-tau),
                                   rtol=1e-12)
    # Radiance identical with/without the flag.
    with np.load(f"{tmp_path}/o1/forward.npz") as z1, \
            np.load(f"{tmp_path}/o2/forward.npz") as z2:
        np.testing.assert_array_equal(z1["radiance"], z2["radiance"])


def test_cli_save_optics_mesh_rejected(tmp_path):
    """save_optics on an unsupported branch must refuse loudly, not skip."""
    from spectrobot_tpu.cli import main
    c = tmp_path / "so.toml"
    c.write_text(_TINY + f"[run]\noutput_dir = \"{tmp_path}/so\"\n"
                 "save_optics = true\n")
    with pytest.raises(ValueError, match="save_optics"):
        main(["forward", str(c), "-o", "compute.mesh_nu=8"])


def test_cli_retrieve_outputs_fitted_spectrum(tmp_path, capsys):
    """retrieval.npz carries the fitted spectrum vs the observations (the
    first thing a reference user inspects), and the converged fit sits at
    the noise level; fit.png is rendered."""
    from spectrobot_tpu.cli import main
    c = tmp_path / "fit.toml"
    c.write_text(_TINY + f"[run]\noutput_dir = \"{tmp_path}/fit\"\n")
    assert main(["retrieve", str(c)]) == 0
    capsys.readouterr()
    with np.load(f"{tmp_path}/fit/retrieval.npz") as z:
        y_fit, y_obs, noise = z["y_fit"], z["y_obs"], z["noise"]
        chans = z["channels_cm1"]
    assert y_fit.shape == y_obs.shape == (2, 40)
    assert chans.shape == (40,)
    resid = (y_obs - y_fit) / noise
    assert np.sqrt(np.mean(resid ** 2)) < 2.0      # at the noise floor
    assert os.path.exists(f"{tmp_path}/fit/fit.png")
    # Both CLI outputs speak the Spectrum format (round-4 review weak item 6):
    # retrieval.npz loads as a radiance Spectrum whose axis is the channel
    # grid and whose values are the fitted spectrum.
    from spectrobot_tpu.spectra import Spectrum
    sp = Spectrum.load_npz(f"{tmp_path}/fit/retrieval.npz")
    assert sp.kind == "radiance"
    np.testing.assert_allclose(np.asarray(sp.nu), chans)
    np.testing.assert_allclose(np.asarray(sp.values), y_fit)
    with np.load(f"{tmp_path}/fit/retrieval.npz") as z:
        assert str(z["units"])  # units metadata present, forward.npz-style
