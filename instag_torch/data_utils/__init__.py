"""Per-video preprocessing (counterpart of instag_tpu/data_utils/): a raw
capture in, the scene directory ``data.dataset.load_frames`` reads out.

    python -m instag_torch.data_utils.process <video> --task -1 \\
        --synthetic_gt <stub> [--device cpu]

In the package, the tasks that need no learned weights:

  * ``process``: audio extraction, frames (an MJPEG AVI through the port's
    own demuxer and nvJPEG; other containers through OpenCV where it
    imports), the background plate and the torso/gt split (numpy and scipy
    on the host, JPEGs through nvJPEG, the 5x5 Gaussian blur in exact
    integer arithmetic), ``transforms_{train,val}.json`` with both split
    rules, and ``--synthetic_gt``, which copies parsing masks, landmarks,
    teeth masks and ``au.csv`` from a generator's stub;
  * ``tracker``: head pose from 68 landmarks, a focal grid search and a
    batched float64 Levenberg-Marquardt PnP on the device;
  * ``audio_features``: the frame windows, the DeepSpeech surrogate and its
    MFCC input, the AVE encoder on the device, and the weight-gated
    Wav2Vec2, HuBERT and DeepSpeech extractors;
  * ``wav2vec_stream``: the chunked streaming ASR front end.

Waiting (ROADMAP.md, "Still to port"): the photometric 3DMM fit
(``face_model``, ``mesh_render``, ``photometric`` and the tracker's fit
branch; item 2), and the learned extractors (``landmarks``,
``face_parsing``, ``easyportrait_fpn`` and ``priors``, with
``create_teeth_masks``' landmark fallback; item 3). Until they land, tasks
4, 7 and 11 need ``--synthetic_gt`` and task 12 is refused.
"""
