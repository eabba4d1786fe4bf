"""Per-video preprocessing (counterpart of instag_tpu/data_utils/): a raw
capture in, the scene directory ``data.dataset.load_frames`` reads out.

    python -m instag_torch.data_utils.process <video> --task -1 \\
        [--synthetic_gt <stub>] [--device cpu]

  * ``process``: the tasks: audio extraction, frames (an MJPEG AVI through
    the port's own demuxer and nvJPEG; other containers through OpenCV
    where it imports), the background plate and the torso/gt split (numpy
    and scipy on the host, JPEGs through nvJPEG, the 5x5 Gaussian blur in
    exact integer arithmetic), ``transforms_{train,val}.json`` with both
    split rules, and ``--synthetic_gt``, which copies parsing masks,
    landmarks, teeth masks and ``au.csv`` from a generator's stub;
  * ``tracker``: head pose from 68 landmarks, a focal grid search and a
    batched float64 Levenberg-Marquardt PnP on the device, then the
    photometric fit where a morphable model is found;
  * ``face_model``, ``mesh_render``, ``photometric``: the linear morphable
    model, the differentiable mesh renderer and the staged fit (A-D);
  * ``landmarks`` (FAN), ``face_parsing`` (BiSeNet), ``easyportrait_fpn``
    and ``priors`` (teeth masks with their landmark fallback, sapiens):
    the learned extractors, which need their checkpoints;
  * ``cv_ops``: OpenCV's resizes and ``fillPoly``, byte for byte, in numpy;
  * ``audio_features``: the frame windows, the DeepSpeech surrogate and its
    MFCC input, the AVE encoder on the device, and the weight-gated
    Wav2Vec2, HuBERT and DeepSpeech extractors;
  * ``wav2vec_stream``: the chunked streaming ASR front end.
"""
