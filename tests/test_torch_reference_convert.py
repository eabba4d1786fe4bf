"""The port's reference-checkpoint converter against the JAX package's.

Torch modules of the reference's architecture and naming (the specs of
tests/test_reference_convert.py, with the mouth branch's beside them) get
random weights. Their state dicts and a reference ``capture()`` tuple, with
Adam groups named as the reference names them, are ``torch.save``d as face,
mouth and fuse trainer checkpoints. Both converters must write the same
bundle bytes from each, and the port must read the bundle back into nets
whose forwards equal the reference modules' and into the same Gaussian
state and Adam moments. The tri-plane lookup of the reference modules goes
through the port's hash grid, whose parity with the reference's grid
encoder tests/test_torch_motion.py holds through the JAX package.
"""

import numpy as np
import pytest
import torch
import torch.nn as tnn

from instag_tpu.data.synthetic import generate_scene
from instag_tpu.io import reference_convert as JR
from instag_torch.cli import synthesize_fuse
from instag_torch.io import reference_convert as TR
from instag_torch.io.checkpoints import (gopt_from_dict, load_branch,
                                         load_bundle, state_from_dict)
from instag_torch.io.from_jax import load_motion_net
from instag_torch.models.gaussians import PARAM_FIELDS
from instag_torch.models.motion import (MotionNetwork, MouthMotionNetwork,
                                        PersonalizedMotionNetwork)
from instag_torch.ops.hashgrid import hashgrid_encode, triplane_config
from tests.test_reference_convert import (TorchAudioAttNet, TorchAudioNet,
                                          TorchMLP)
from tests.test_torch_audio import reference_ave_state_dict
from tests.torch_cpu import one_torch_thread  # noqa: F401

N, CAP, SH = 50, 64, 2
BOUND = 0.15


class _Triplane(tnn.Module):
    """The reference's encode_x: xy/yz/xz planes, one hash grid each, its
    tables ``encoder_<ax>.embeddings``."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        for ax in ("xy", "yz", "xz"):
            mod = tnn.Module()
            mod.embeddings = tnn.Parameter(
                torch.rand(cfg.total_params(), cfg.level_dim) * 0.6 - 0.3)
            setattr(self, f"encoder_{ax}", mod)

    def forward(self, x):
        planes = (x[:, :-1], x[:, 1:], torch.cat([x[:, :1], x[:, -1:]], -1))
        return torch.cat([
            hashgrid_encode(self.cfg, getattr(self, f"encoder_{ax}").embeddings,
                            p, BOUND)
            for ax, p in zip(("xy", "yz", "xz"), planes)], dim=-1)


class _RefNet(tnn.Module):
    """Reference MotionNetwork (face), MouthMotionNetwork and
    PersonalizedMotionNetwork (face, mouth) forwards under the reference's
    parameter names."""

    def __init__(self, kind: str):
        super().__init__()
        self.kind = kind
        mouth_umf = kind == "mouth_umf"
        self.audio_net = TorchAudioNet()
        self.audio_att_net = TorchAudioAttNet()
        self.tri = _Triplane(triplane_config(64, 384 * BOUND) if mouth_umf
                             else triplane_config(16, 256 * BOUND))
        if kind == "face_umf":
            self.sigma_net = TorchMLP(36 + 32 + 6, 11, 64, 3)
        elif kind == "mouth_umf":
            self.sigma_net = TorchMLP(36 + 32 + 3, 7, 32, 3)
            self.scaler_net = TorchMLP(36 + 3, 1, 16, 3)
        elif kind == "face_pmf":
            self.sigma_net = TorchMLP(36 + 32 + 6, 11, 32, 3)
            self.align_net = TorchMLP(36, 6, 32, 2)
        else:
            self.sigma_net = TorchMLP(36 + 32, 7, 16, 3)
            self.align_net = TorchMLP(36, 6, 16, 2)
        if kind in ("face_umf", "face_pmf"):
            self.exp_encode_net = TorchMLP(5, 5, 16, 2)
            self.eye_att_net = TorchMLP(36, 6, 16, 2)
        # the mouth UMF declares one and never calls it
        self.aud_ch_att_net = TorchMLP(36, 32, 32, 2)

    def ref_state_dict(self):
        return {n.replace("tri.", ""): p.detach().clone()
                for n, p in self.named_parameters()}

    def forward(self, x, a, e, move):
        enc_x = self.tri(x)
        enc_a = self.audio_att_net(self.audio_net(a)[None])
        enc_a = enc_a.repeat(enc_x.shape[0], 1)
        if self.kind == "mouth_umf":
            mv = move.repeat(enc_x.shape[0], 1)
            h = self.sigma_net(torch.cat([enc_x, enc_a, mv], -1))
            tau = self.scaler_net(torch.cat([enc_x, mv], -1))
            d_xyz = h[..., :3] * 1e-2 * torch.tensor([0.2, 1.0, 0.2])
            return {"d_xyz": d_xyz * torch.sigmoid(tau) * 2.0,
                    "d_rot": h[..., 3:]}
        h = torch.cat([enc_x, enc_a * self.aud_ch_att_net(enc_x)], -1)
        if self.kind in ("face_umf", "face_pmf"):
            eye_att = torch.relu(self.eye_att_net(enc_x))
            enc_e = torch.cat([self.exp_encode_net(e[:-1]), e[-1:]], -1)
            h = torch.cat([h, enc_e * eye_att], -1)
        h = self.sigma_net(h)
        out = {"d_xyz": h[..., :3] * 1e-2, "d_rot": h[..., 3:7]}
        if self.kind.startswith("face"):
            out.update(d_opa=h[..., 7:8], d_scale=h[..., 8:11])
        if self.kind.endswith("pmf"):
            p = self.align_net(enc_x)
            out.update(p_xyz=p[..., :3] * 1e-2,
                       p_scale=torch.tanh(p[..., 3:] / 5) * 0.25 + 1)
        return out


def _capture(rng, pmf_sd):
    """A reference ``capture()`` tuple of N points at SH degree SH, its
    Adam state dict with the reference's named groups (and a
    ``neural_motion_grid`` group the converter skips)."""
    def t(*shape):
        return torch.tensor(rng.normal(size=shape).astype(np.float32))
    k = (SH + 1) ** 2
    fields = (t(N, 3), t(N, 1, 3), t(N, k - 1, 3), t(N, 1), t(N, 3),
              t(N, 4), t(N, 1))
    names = ("xyz", "f_dc", "f_rest", "identity", "scaling", "rotation",
             "opacity")
    opt_sd = {"state": {}, "param_groups": []}
    for pid, (name, value) in enumerate(zip(names, fields)):
        opt_sd["state"][pid] = {"step": torch.tensor(23.0),
                                "exp_avg": t(*value.shape),
                                "exp_avg_sq": t(*value.shape) ** 2}
        opt_sd["param_groups"].append({"name": name, "params": [pid],
                                       "lr": 1e-3})
    opt_sd["param_groups"].append({"name": "neural_motion_grid",
                                   "params": [len(names)], "lr": 1e-3})
    capture = (1, *fields, torch.tensor(rng.uniform(0, 9, N)
                                        .astype(np.float32)),
               t(N, 1).abs(), t(N, 1).abs(), opt_sd, 1.7, None, pmf_sd)
    return capture, dict(zip(names, fields)), opt_sd


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference modules and the face, mouth and fuse checkpoints."""
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    nets = {k: _RefNet(k).eval() for k in ("face_umf", "mouth_umf",
                                            "face_pmf", "mouth_pmf")}
    sds = {k: n.ref_state_dict() for k, n in nets.items()}
    face_cap, face_fields, face_opt = _capture(rng, sds["face_pmf"])
    mouth_cap, mouth_fields, mouth_opt = _capture(rng, sds["mouth_pmf"])
    d = tmp_path_factory.mktemp("ref")
    paths = {"face": str(d / "face.pth"), "mouth": str(d / "mouth.pth"),
             "fuse": str(d / "fuse.pth")}
    torch.save((face_cap, sds["face_umf"], {}, 700), paths["face"])
    torch.save((mouth_cap, sds["mouth_umf"], {}, 400), paths["mouth"])
    torch.save((face_cap, sds["face_umf"], mouth_cap, sds["mouth_umf"]),
               paths["fuse"])
    return dict(nets=nets, paths=paths, dir=d,
                fields={"face": face_fields, "mouth": mouth_fields},
                opts={"face": face_opt, "mouth": mouth_opt})


@pytest.mark.parametrize("kind", ["face", "mouth", "fuse"])
def test_bundle_bytes_match_jax(reference, kind):
    d = reference["dir"]
    j_out = JR.convert_reference_checkpoint(
        reference["paths"][kind], str(d / f"{kind}_jax.pkl"), kind, CAP,
        "deepspeech")
    t_out = TR.convert_reference_checkpoint(
        reference["paths"][kind], str(d / f"{kind}_port.pkl"), kind, CAP,
        "deepspeech")
    with open(j_out, "rb") as f, open(t_out, "rb") as g:
        assert f.read() == g.read()


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.17, 0.17, (200, 3)).astype(np.float32)  # some OOB
    a = rng.normal(size=(8, 29, 16)).astype(np.float32)
    e = np.abs(rng.normal(0.3, 0.2, 6)).astype(np.float32)
    move = np.array([[0.6, -0.4, 1.0]], np.float32)
    return [torch.from_numpy(v) for v in (x, a, e, move)]


def _same_forward(ours, ref_net, kind):
    x, a, e, move = _inputs()
    with torch.no_grad():
        want = ref_net(x, a, e, move)
        got = (ours(x, a, move) if kind == "mouth_umf"
               else ours(x, a, e))
    assert want["d_xyz"].abs().max() > 0
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=f"{kind} {k}")


def _same_state(state, gopt, fields, opt_sd):
    assert state.capacity == CAP and int(state.num_alive()) == N
    assert state.max_sh_degree == SH and state.active_sh_degree == 1
    assert state.spatial_lr_scale == pytest.approx(1.7)
    names = ("xyz", "features_dc", "features_rest", "identity", "scaling",
             "rotation", "opacity")
    for name, (ref_name, value) in zip(names, fields.items()):
        got = getattr(state.params, name).numpy()
        np.testing.assert_array_equal(got[:N], value.numpy())
        assert not got[N:].any()
        if gopt is not None:
            pid = list(fields).index(ref_name)
            np.testing.assert_array_equal(
                getattr(gopt.mu, name).numpy()[:N],
                opt_sd["state"][pid]["exp_avg"].numpy())
            np.testing.assert_array_equal(
                getattr(gopt.nu, name).numpy()[:N],
                opt_sd["state"][pid]["exp_avg_sq"].numpy())
    if gopt is not None:
        assert gopt.step == 23
    assert set(PARAM_FIELDS) == set(names)


@pytest.mark.parametrize("kind", ["face", "mouth"])
def test_port_reads_the_bundle(reference, kind, tmp_path):
    path = TR.convert_reference_checkpoint(
        reference["paths"][kind], str(tmp_path / "b.pkl"), kind, CAP,
        "deepspeech")
    b = load_bundle(path)
    assert b["iteration"] == (700 if kind == "face" else 400)
    r = load_branch(path, kind, device="cpu")
    _same_forward(r["umf_net"], reference["nets"][f"{kind}_umf"],
                  f"{kind}_umf")
    _same_forward(r["pmf_net"], reference["nets"][f"{kind}_pmf"],
                  f"{kind}_pmf")
    _same_state(r["state"], gopt_from_dict(b["gopt"], device="cpu"),
                reference["fields"][kind], reference["opts"][kind])


def test_port_reads_the_fuse_bundle(reference, tmp_path):
    b = load_bundle(TR.convert_reference_checkpoint(
        reference["paths"]["fuse"], str(tmp_path / "fuse.pkl"), "fuse", CAP,
        "deepspeech"))
    nets = {"face_umf": MotionNetwork(), "mouth_umf": MouthMotionNetwork(),
            "face_pmf": PersonalizedMotionNetwork("face"),
            "mouth_pmf": PersonalizedMotionNetwork("mouth")}
    for kind, net in nets.items():
        _same_forward(load_motion_net(net, b[f"{kind}_params"], "cpu"),
                      reference["nets"][kind], kind)
    for branch in ("face", "mouth"):
        _same_state(state_from_dict(b[f"{branch}_state"], device="cpu"),
                    None, reference["fields"][branch],
                    reference["opts"][branch])


def test_converted_fuse_bundle_synthesizes(reference, tmp_path, capsys):
    """A converted reference fuse checkpoint is a run directory the
    ``synthesize_fuse`` CLI renders a clip from."""
    scene, run = str(tmp_path / "scene"), tmp_path / "run"
    generate_scene(scene, n_frames=2, size=32, n_val=2)
    TR.convert_reference_checkpoint(reference["paths"]["fuse"],
                                    str(run / "chkpnt_fuse_latest.pkl"),
                                    "fuse", CAP, "deepspeech")
    synthesize_fuse.main(["-m", str(run), "-s", scene, "--fast",
                          "--device", "cpu"])
    assert "synthesized 2 frames" in capsys.readouterr().out
    assert any((run / f"out.mp4{x}").exists() for x in ("", ".frames.npz"))


def test_ave_encoder_npz_matches_jax(tmp_path):
    sd = reference_ave_state_dict()
    # a wrapping module prefix, as some checkpoints carry
    sd = {f"model.{k}": v for k, v in sd.items()}
    ref = np.load(JR.convert_ave_encoder(sd, str(tmp_path / "j.npz")))
    out = np.load(TR.convert_ave_encoder(sd, str(tmp_path / "t.npz")))
    assert sorted(out.files) == sorted(ref.files) and len(ref.files) == 78
    for k in ref.files:
        assert out[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
