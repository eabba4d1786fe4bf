"""Audio features (task 2; counterpart of
instag_tpu/data_utils/audio_features.py): the four extractor families.

Layouts are the reference's on-disk contract:
  aud_ds.npy  [T, 16, 29]   DeepSpeech logits windows
  aud_eo.npy  [T, 16, 44]   Wav2Vec2 esperanto logits windows
  aud_hu.npy  [T, 16, 1024] HuBERT features windows
  aud_ave.npy [T+4, 512, 1] AVE (SyncTalk audio-visual encoder) embeddings

DeepSpeech needs the TF1 frozen graph (``DEEPSPEECH_PB``) and otherwise
writes a documented surrogate of the same contract; Wav2Vec2 and HuBERT
need a local HuggingFace cache and run on ``device``; the AVE encoder
(``models.nets.AudioEncoder``) runs on ``device`` with the JAX package's
weights file or, without it, a seeded random init. The windowing, the
surrogate and the MFCC are numpy on the host, as in the JAX package.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from ..data.audio import AudioWindows, _stft_mag, load_wav, mel_filterbank
from ..device import resolve_device
from ..io.from_jax import load_audio_encoder
from ..models.nets import AudioEncoder


def make_frame_windows(feats: np.ndarray, num_video_frames: int,
                       win: int = 16) -> np.ndarray:
    """Resample per-step features [S, D] to the video frame rate and build
    the centred 16-step window per frame -> [T, 16, D]
    (deepspeech_features windowing semantics)."""
    s, d = feats.shape
    # linear-resample feature steps so that 2 steps ≈ 1 video frame (the
    # deepspeech pipeline produces ~50 windows/s for 25 fps video)
    src = np.linspace(0, s - 1, num_video_frames * 2)
    idx0 = np.floor(src).astype(int)
    idx1 = np.minimum(idx0 + 1, s - 1)
    a = (src - idx0)[:, None]
    steps = feats[idx0] * (1 - a) + feats[idx1] * a     # [2T, D]

    half = win // 2
    padded = np.concatenate([np.zeros((half, d), feats.dtype), steps,
                             np.zeros((half, d), feats.dtype)], 0)
    out = np.stack([padded[2 * t: 2 * t + win]
                    for t in range(num_video_frames)])
    return out.astype(np.float32)


def _video_frame_count(base_dir: str) -> int:
    return len(glob.glob(os.path.join(base_dir, "ori_imgs", "*.jpg")))


def _frame_count(wav_path: str, n_samples: int) -> int:
    """The video's frame count (its extracted JPEGs), else the WAV's
    length at 25 fps."""
    return _video_frame_count(os.path.dirname(wav_path)) or int(
        n_samples / 16000 * 25)


def extract_wav2vec(wav_path: str, out_path: str,
                    model_name: str = "cpierse/wav2vec2-large-xlsr-53-esperanto",
                    device: str | torch.device = "cuda"):
    """Esperanto Wav2Vec2 CTC logits, from a local HuggingFace cache only,
    run on ``device``."""
    from transformers import Wav2Vec2ForCTC, Wav2Vec2Processor
    dev = resolve_device(device)
    try:
        processor = Wav2Vec2Processor.from_pretrained(model_name,
                                                      local_files_only=True)
        model = Wav2Vec2ForCTC.from_pretrained(model_name,
                                               local_files_only=True)
    except Exception as e:
        raise RuntimeError(
            f"HF checkpoint {model_name} not in the local cache (no "
            "network egress); pre-populate the cache to use this "
            "extractor") from e
    wav = load_wav(wav_path, 16000)
    inputs = processor(wav, sampling_rate=16000, return_tensors="pt")
    with torch.no_grad():
        logits = model.to(dev).eval()(inputs.input_values.to(dev)
                                      ).logits[0].cpu().numpy()
    np.save(out_path, make_frame_windows(logits,
                                         _frame_count(wav_path, len(wav))))


def extract_hubert(wav_path: str, out_path: str,
                   model_name: str = "facebook/hubert-large-ls960-ft",
                   device: str | torch.device = "cuda"):
    """HuBERT hidden features in 20 s chunks with 0.1 s of context, from a
    local HuggingFace cache only, run on ``device``."""
    from transformers import HubertModel, Wav2Vec2FeatureExtractor
    dev = resolve_device(device)
    try:
        fe = Wav2Vec2FeatureExtractor.from_pretrained(model_name,
                                                      local_files_only=True)
        model = HubertModel.from_pretrained(model_name, local_files_only=True)
    except Exception as e:
        raise RuntimeError(
            f"HF checkpoint {model_name} not in the local cache (no "
            "network egress)") from e
    model = model.to(dev).eval()
    wav = load_wav(wav_path, 16000)
    chunks = []
    step = 16000 * 20
    with torch.no_grad():
        for s in range(0, len(wav), step):
            seg = wav[max(0, s - 1600): s + step + 1600]
            inp = fe(seg, sampling_rate=16000, return_tensors="pt")
            chunks.append(model(inp.input_values.to(dev)
                                ).last_hidden_state[0].cpu().numpy())
    feats = np.concatenate(chunks, 0)
    np.save(out_path, make_frame_windows(feats,
                                         _frame_count(wav_path, len(wav))))


def ave_encoder(device: str | torch.device = "cuda") -> AudioEncoder:
    """The AVE ``AudioEncoder`` in eval mode on ``device``: the variables
    in ``INSTAG_AVE_WEIGHTS`` (default ``weights/ave_encoder.npz``, the
    flax-flat npz the JAX package reads, every variable present), else a
    warning and PyTorch's default init drawn under seed 0."""
    dev = resolve_device(device)
    wpath = os.environ.get("INSTAG_AVE_WEIGHTS", "weights/ave_encoder.npz")
    if os.path.exists(wpath):
        with np.load(wpath) as data:
            return load_audio_encoder(AudioEncoder(), dict(data), dev)
    print(f"[WARN] AVE weights not found at {wpath}; using random "
          "init — features will not match SyncTalk's")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return AudioEncoder().to(dev).eval()


def extract_ave(wav_path: str, out_path: str,
                device: str | torch.device = "cuda"):
    """AVE embeddings [T + 4, 512, 1]: every 16-step mel crop through the
    encoder on ``device`` in one batch, the first and last repeated
    twice."""
    dev = resolve_device(device)
    enc = ave_encoder(dev)
    ds = AudioWindows(load_wav(wav_path, 16000))
    crops = torch.from_numpy(np.stack([ds[i] for i in range(len(ds))]))
    with torch.no_grad():
        outs = enc(crops.to(dev)).cpu().numpy()              # [T, 512]
    first, last = outs[:1], outs[-1:]
    padded = np.concatenate([np.repeat(first, 2, 0), outs,
                             np.repeat(last, 2, 0)], 0)
    np.save(out_path, padded[:, :, None].astype(np.float32))  # [T+4, 512, 1]


def deepspeech_surrogate_features(wav: np.ndarray, sr: int = 16000,
                                  rate_hz: float = 50.0) -> np.ndarray:
    """29-dim acoustic features at 50 windows/s — the DeepSpeech output
    CONTRACT (deepspeech_features/deepspeech_features.py:16-108 emits 29-dim
    logits resampled to 50 Hz) filled by a documented surrogate when the TF1
    frozen graph is unavailable: 26 log-mel filterbank energies + log-energy
    + spectral centroid + spectral flux, per 20 ms hop. NOT numerically equal
    to DeepSpeech logits — it is a stand-in acoustic representation with the
    same shape, rate, and windowing, so the `deepspeech` config trains and
    runs end-to-end; swap in real `aud_ds.npy` files for reference parity.
    """
    hop = int(sr / rate_hz)
    n_fft = 512
    mag = _stft_mag(wav.astype(np.float32), n_fft=n_fft, hop=hop, win=n_fft)
    mel = mel_filterbank(sr=sr, n_fft=n_fft, n_mels=26, fmin=20.0,
                         fmax=sr / 2 - 100.0)
    logmel = np.log(mel @ mag + 1e-6).T                      # [T, 26]
    energy = np.log(np.sum(mag ** 2, axis=0) + 1e-6)[:, None]
    freqs = np.linspace(0, sr / 2, mag.shape[0])[:, None]
    centroid = ((freqs * mag).sum(0) / np.maximum(mag.sum(0), 1e-6))[:, None]
    centroid = centroid / (sr / 2)
    flux = np.concatenate(
        [np.zeros((1,)), np.sqrt(((np.diff(mag, axis=1)) ** 2).sum(0))]
    )[:, None]
    feats = np.concatenate(
        [logmel, energy, centroid, np.log(flux + 1e-6)], axis=1)  # [T, 29]
    # per-dim standardization (DeepSpeech logits are roughly unit-scale)
    feats = (feats - feats.mean(0)) / np.maximum(feats.std(0), 1e-6)
    return feats.astype(np.float32)


def extract_deepspeech(wav_path: str, out_path: str):
    """DeepSpeech 29-dim windows -> aud_ds.npy.

    Uses the real TF1 frozen graph when ``DEEPSPEECH_PB`` points at
    deepspeech-0.1.0's output_graph.pb (requires tensorflow); otherwise computes the documented surrogate features
    (:func:`deepspeech_surrogate_features`) with a loud notice.
    """
    pb = os.environ.get("DEEPSPEECH_PB", "")
    if pb and os.path.exists(pb):
        try:
            return _extract_deepspeech_tf(wav_path, out_path, pb)
        except ImportError as e:
            print(f"[WARN] DeepSpeech graph present but tensorflow missing "
                  f"({e}); falling back to surrogate features")
    else:
        print("[NOTE] DeepSpeech TF1 graph not available (set DEEPSPEECH_PB)"
              " — writing surrogate 29-dim features (same contract/windowing"
              ", not DeepSpeech logits; see deepspeech_surrogate_features)")
    wav = load_wav(wav_path, 16000)
    feats = deepspeech_surrogate_features(wav)
    np.save(out_path, make_frame_windows(feats,
                                         _frame_count(wav_path, len(wav))))


def _psf_mfcc(wav: np.ndarray, sr: int = 16000, numcep: int = 26,
              nfilt: int = 26, winlen: float = 0.025, winstep: float = 0.01,
              n_fft: int = 512, preemph: float = 0.97,
              ceplifter: int = 22) -> np.ndarray:
    """python_speech_features-compatible MFCC (the exact transform the
    reference feeds DeepSpeech, deepspeech_features.py:206-210): preemphasis,
    rectangular window, power spectrum, 26 mel filters, DCT-II ortho,
    liftering, c0 replaced by log frame energy (appendEnergy=True)."""
    sig = np.append(wav[0], wav[1:] - preemph * wav[:-1]).astype(np.float64)
    frame_len = int(round(winlen * sr))
    step = int(round(winstep * sr))
    n = 1 + max(0, int(np.ceil((len(sig) - frame_len) / step)))
    pad = np.concatenate([sig, np.zeros(max(0, (n - 1) * step + frame_len
                                            - len(sig)))])
    idx = (np.arange(frame_len)[None, :]
           + step * np.arange(n)[:, None])
    frames = pad[idx]                                   # [n, frame_len]
    pspec = (np.abs(np.fft.rfft(frames, n_fft)) ** 2) / n_fft
    energy = np.maximum(pspec.sum(1), np.finfo(np.float64).eps)
    # HTK-mel triangular filterbank, unnormalized, bin-index edges
    # (python_speech_features.get_filterbanks)
    hz2mel = lambda f: 2595.0 * np.log10(1.0 + f / 700.0)
    mel2hz = lambda m: 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    melpts = np.linspace(hz2mel(0.0), hz2mel(sr / 2.0), nfilt + 2)
    bins = np.floor((n_fft + 1) * mel2hz(melpts) / sr).astype(int)
    fb = np.zeros((nfilt, n_fft // 2 + 1))
    for j in range(nfilt):
        for i in range(bins[j], bins[j + 1]):
            fb[j, i] = (i - bins[j]) / max(bins[j + 1] - bins[j], 1)
        for i in range(bins[j + 1], bins[j + 2]):
            fb[j, i] = (bins[j + 2] - i) / max(bins[j + 2] - bins[j + 1], 1)
    feat = np.maximum(pspec @ fb.T, np.finfo(np.float64).eps)
    from scipy.fftpack import dct
    ceps = dct(np.log(feat), type=2, axis=1, norm="ortho")[:, :numcep]
    if ceplifter > 0:
        lift = 1 + (ceplifter / 2.0) * np.sin(
            np.pi * np.arange(numcep) / ceplifter)
        ceps = ceps * lift
    ceps[:, 0] = np.log(energy)
    return ceps


def _deepspeech_input_vector(wav: np.ndarray, num_cepstrum: int = 26,
                             num_context: int = 9) -> np.ndarray:
    """MFCC -> stride-2 -> 19-frame context windows -> global standardize
    (deepspeech_features.py:205-238, the DeepSpeech 0.1.0 input contract)."""
    feats = _psf_mfcc(wav)[::2]                         # BiRNN stride 2
    pad = np.zeros((num_context, num_cepstrum), feats.dtype)
    feats = np.concatenate([pad, feats, pad])
    win = 2 * num_context + 1
    s = len(feats) - win + 1
    windows = np.stack([feats[i:i + win].reshape(-1) for i in range(s)])
    return ((windows - windows.mean()) / windows.std()).astype(np.float32)


def _extract_deepspeech_tf(wav_path: str, out_path: str, pb: str):
    """Run the reference's TF1 frozen DeepSpeech 0.1.0 graph
    (deepspeech_features/deepspeech_features.py:79-108: import_graph_def,
    feed input_node/input_lengths, fetch logits) and window the 29-dim
    logits to the aud_ds.npy contract."""
    import tensorflow.compat.v1 as tf  # optional dependency, gated by caller
    with tf.io.gfile.GFile(pb, "rb") as f:
        graph_def = tf.GraphDef()
        graph_def.ParseFromString(f.read())
    graph = tf.Graph()
    with graph.as_default():
        tf.import_graph_def(graph_def, name="deepspeech")
    logits_t = graph.get_tensor_by_name("deepspeech/logits:0")
    input_t = graph.get_tensor_by_name("deepspeech/input_node:0")
    lengths_t = graph.get_tensor_by_name("deepspeech/input_lengths:0")

    wav = load_wav(wav_path, 16000)
    vec = _deepspeech_input_vector((wav * 32767).astype(np.int16))
    with tf.Session(graph=graph) as sess:
        logits = sess.run(logits_t, feed_dict={
            input_t: vec[None], lengths_t: [vec.shape[0]]})
    feats = logits.reshape(-1, 29)                      # [S, 29] at ~50 Hz
    np.save(out_path, make_frame_windows(feats,
                                         _frame_count(wav_path, len(wav))))


def extract_features(wav_path: str, mode: str = "deepspeech",
                     device: str | torch.device = "cuda") -> None:
    """Task 2: the ``mode`` extractor's windows next to the WAV."""
    base = os.path.dirname(wav_path)
    if mode in ("wav2vec", "esperanto"):
        extract_wav2vec(wav_path, os.path.join(base, "aud_eo.npy"),
                        device=device)
    elif mode == "hubert":
        extract_hubert(wav_path, os.path.join(base, "aud_hu.npy"),
                       device=device)
    elif mode == "ave":
        extract_ave(wav_path, os.path.join(base, "aud_ave.npy"), device)
    else:
        extract_deepspeech(wav_path, os.path.join(base, "aud_ds.npy"))
