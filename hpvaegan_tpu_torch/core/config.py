"""Config system: one dataclass + flag-compatible argparse shims.

A copy of ``hpvaegan_tpu/core/config.py`` (the port imports nothing of the
JAX package): the same fields, flags and defaults, so a ``config.json``
written by either package configures the other.  The accelerator-specific
flags parse identically; what each means for this package is decided by
the slice that ports its code path.

The reference threads a mutated argparse ``opt`` namespace everywhere
(train_video.py:262-374).  Here the same flag surface (names, defaults,
semantics — train_video.py:262-321, train_image.py:276-333,
train_video_baselines.py:216-250) parses into a single ``Config`` dataclass;
derived pyramid/runtime fields live in explicit attributes instead of ad-hoc
namespace mutation.  ``Config`` is intentionally a plain mutable dataclass so
trainers can attach run state the same way users of the reference expect
(drop-in "opt" object), but all *compute* functions take explicit arguments.

TPU-specific additions (not in the reference) are grouped at the bottom:
``bf16``, ``mesh_shape``, ``spmd``.  ``--no-cuda`` is kept verbatim and means
"don't use the accelerator" (maps to forcing the CPU backend).
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Any, List, Optional, Tuple

from .pyramid import Pyramid

__all__ = ["Config", "build_parser", "config_from_args"]


@dataclasses.dataclass
class Config:
    # load / input / save
    netG: str = ""
    netD: str = ""
    manualSeed: Optional[int] = None

    # network hyper parameters (train_video.py:270-280)
    nc_im: int = 3
    nfc: int = 64
    latent_dim: int = 128
    vae_levels: int = 3
    enc_blocks: int = 2
    ker_size: int = 3
    num_layer: int = 5
    stride: Any = 1
    padd_size: int = 1
    generator: str = "GeneratorHPVAEGAN"
    discriminator: str = "WDiscriminator3D"

    # pyramid parameters (train_video.py:283-286)
    scale_factor: float = 0.75
    noise_amp: float = 0.1
    min_size: int = 32
    max_size: int = 256

    # optimization hyper parameters (train_video.py:289-301)
    niter: int = 50000
    lr_g: float = 0.0005
    lr_d: float = 0.0005
    beta1: float = 0.5
    lambda_grad: float = 0.1
    rec_weight: float = 10.0
    kl_weight: float = 1.0
    disc_loss_weight: float = 1.0
    lr_scale: float = 0.2
    train_depth: int = 1
    grad_clip: float = 5.0
    const_amp: bool = False
    train_all: bool = False

    # baselines extras (train_video_baselines.py:225-250)
    nc_z: int = 3
    Gsteps: int = 1
    Dsteps: int = 1
    alpha: float = 10.0

    # dataset (train_video.py:304-311)
    video_path: str = ""
    image_path: str = ""
    start_frame: int = 0
    max_frames: int = 1000
    hflip: bool = False
    img_size: int = 256
    sampling_rates: Tuple[int, ...] = (4, 3, 2, 1)
    stop_scale_time: int = -1
    data_rep: int = 1

    # main arguments (train_video.py:314-319)
    checkname: str = "DEBUG"
    mode: str = "train"
    batch_size: int = 2
    print_interval: int = 100
    visualize: bool = False
    no_cuda: bool = False          # kept verbatim: disables the accelerator
    tag: str = ""                  # train_image.py only (neptune tag)

    # ---- TPU-native extensions (not in the reference) ----
    bf16: bool = False             # bfloat16 conv compute, f32 params/accum
    fast_grads: bool = False       # differentiate trainable params only
    hoist_prefix: bool = False     # with --fast-grads in the GAN phase:
    #                                compute the frozen generator prefix
    #                                (encoder/decoder + frozen stages) once
    #                                and reuse the critic-step rand prefix
    #                                in the generator step (gradient-exact).
    #                                Measured a program-level no-op — XLA CSE
    #                                already dedups the identical prefix
    #                                inside the jitted step (BENCHMARKS.md
    #                                anti-result) — so opt-in only.
    fused_forwards: bool = False   # batch rec+rand generator forwards
    wpack: bool = False            # width-packed convs at large scales
    pconv: bool = False            # packed-lane Pallas conv kernel (critic)
    pconv_all: bool = False        # ...generator stages too (measured slower)
    pfuse: bool = False            # fuse critic-body conv+lrelu PAIRS in one
    #                                Pallas kernel (intermediate stays in
    #                                VMEM; ops/pallas/conv3d_fuse.py)
    host_loader: bool = False      # host prefetch pipeline instead of the
    #                                device-resident frame cache
    profile_dir: str = ""          # torch.profiler Chrome trace output dir
    compile_ahead: bool = False    # compile next scale's programs during
    #                                this scale's training (a thread lowers
    #                                from abstract shapes; no HBM touched)
    decode_ahead: bool = False     # decode next scale's video frames during
    #                                this scale's training (host thread;
    #                                OpenCV releases the GIL)
    scan_steps: int = 1            # iterations per dispatch (lax.scan)
    remat: bool = False            # jax.checkpoint refinement stages + critic
    remat_blocks: bool = False     # nn.remat each conv block (finer, slower)
    gp_chunked: bool = False       # per-sample WGAN-GP double-backprop (lax.map)
    watchdog: float = 0.0          # exit 75 if no chunk completes for this
    #                                many seconds (0 = off); relay wedges
    #                                become clean resumable exits
    save_interval: int = 0         # intra-scale checkpoint every N iterations
    #                                (netG_mid: params + BOTH optimizer states
    #                                + iteration; 0 = end-of-scale only)
    distributed: bool = False      # one rank of a torch.distributed launch
    mesh_shape: str = ""           # e.g. "2x4" -> ('data','spatial') mesh
    spmd: bool = False             # shard the train step over the mesh
    run_dir: str = "run"           # root of the experiment tree

    # ---- derived state, filled by trainers (mirrors opt mutation) ----
    noise_amp_init: float = 0.1
    scale_factor_init: float = 0.75
    num_scales: int = 0
    stop_scale: int = 0
    scale1: float = 1.0
    ar: float = 1.0
    org_fps: float = 30.0
    fps_lcm: int = 12
    fps: float = 30.0
    td: int = 1
    fps_index: int = 0
    scale_idx: int = 0
    resumed_idx: int = -1
    resume_dir: str = ""
    resume_iteration: int = 0      # >0: resume mid-scale from this iteration
    Noise_Amps: List[float] = dataclasses.field(default_factory=list)

    # non-serializable runtime attachments (saver, summary, dataset, ...)
    # are plain attributes set by trainers; dataclasses allow that.

    def pyramid(self) -> Pyramid:
        """Build the immutable pyramid from derived fields (video flavor)."""
        return Pyramid.for_video(
            img_size=self.img_size, ar=self.ar, min_size=self.min_size,
            max_size=self.max_size, scale_factor_init=self.scale_factor_init,
            sampling_rates=self.sampling_rates, org_fps=self.org_fps,
            stop_scale_time=self.stop_scale_time)

    def pyramid2d(self) -> Pyramid:
        return Pyramid.for_image(
            img_size=self.img_size, ar=self.ar, min_size=self.min_size,
            max_size=self.max_size, scale_factor_init=self.scale_factor_init)

    def snapshot_dict(self) -> dict:
        """JSON-safe dict of every declared field — written as
        ``config.json`` in the experiment dir at train start so generation
        and resume can rebuild the exact module tree without hand-re-
        specifying flags (VERDICT r1 item 4).  Runtime attachments (saver,
        dataset, Z_init, ...) are plain attributes, not fields — excluded
        by construction."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, tuple):
                v = list(v)
            out[f.name] = v
        return out

    def adjust_scales(self) -> None:
        """Mirror utils.adjust_scales2image side effects onto this config."""
        from .pyramid import adjust_scales
        self.noise_amp_init = self.noise_amp
        self.scale_factor_init = self.scale_factor
        adj = adjust_scales(self.img_size, self.min_size, self.max_size,
                            self.scale_factor_init)
        self.num_scales = adj.num_scales
        self.stop_scale = adj.stop_scale
        self.scale1 = adj.scale1
        self.scale_factor = adj.scale_factor
        if self.stop_scale_time == -1:
            self.stop_scale_time = self.stop_scale
        if self.spmd and self.pfuse:
            # pallas_call has no SPMD partitioning rule.  --pconv composes
            # with --spmd via the shard_map+halo wrapper (ops/pallas/
            # conv3d_spmd.py, per-shard routing in models/blocks.py), but
            # the fused conv-PAIR kernel would need a 2-row halo protocol
            # and measured flat even single-chip (BENCHMARKS.md pfuse
            # anti-result) — under a mesh it stays off.
            import logging
            logging.getLogger("hpvaegan_tpu_torch").warning(
                "--pfuse is incompatible with --spmd (the conv-pair kernel "
                "has no mesh partitioning); disabling pfuse for this run")
            self.pfuse = False


_COMMON_FLAGS = [
    # (flags, kwargs)
    (["--netG"], dict(default="", help="path to netG (to continue training)")),
    (["--netD"], dict(default="", help="path to netD (to continue training)")),
    (["--manualSeed"], dict(type=int, help="manual seed")),
    (["--nc-im"], dict(type=int, default=3, help="# channels")),
    (["--nfc"], dict(type=int, default=64, help="model basic # channels")),
    (["--latent-dim"], dict(type=int, default=128, help="Latent dim size")),
    (["--vae-levels"], dict(type=int, default=3, help="# VAE levels")),
    (["--enc-blocks"], dict(type=int, default=2, help="# encoder blocks")),
    (["--ker-size"], dict(type=int, default=3, help="kernel size")),
    (["--num-layer"], dict(type=int, default=5, help="number of layers")),
    (["--stride"], dict(default=1, help="stride")),
    (["--padd-size"], dict(type=int, default=1, help="net pad size")),
    (["--scale-factor"], dict(type=float, default=0.75, help="pyramid scale factor")),
    (["--noise_amp"], dict(type=float, default=0.1, help="addative noise cont weight")),
    (["--min-size"], dict(type=int, default=32, help="image minimal size at the coarser scale")),
    (["--max-size"], dict(type=int, default=256, help="image maximal size at the finest scale")),
    (["--niter"], dict(type=int, default=50000, help="number of iterations to train per scale")),
    (["--lr-g"], dict(type=float, default=0.0005, help="generator learning rate")),
    (["--lr-d"], dict(type=float, default=0.0005, help="discriminator learning rate")),
    (["--beta1"], dict(type=float, default=0.5, help="beta1 for adam")),
    (["--lambda-grad"], dict(type=float, default=0.1, help="gradient penalty weight")),
    (["--rec-weight"], dict(type=float, default=10.0, help="reconstruction loss weight")),
    (["--disc-loss-weight"], dict(type=float, default=1.0, help="discriminator weight")),
    (["--lr-scale"], dict(type=float, default=0.2, help="scaling of learning rate for lower stages")),
    (["--train-depth"], dict(type=int, default=1, help="how many layers are trained if growing")),
    (["--hflip"], dict(action="store_true", default=False, help="horizontal flip")),
    (["--img-size"], dict(type=int, default=256)),
    (["--data-rep"], dict(type=int, default=1, help="data repetition")),
    (["--checkname"], dict(type=str, default="DEBUG", help="check name")),
    (["--mode"], dict(default="train", help="task to be done")),
    (["--batch-size"], dict(type=int, default=2, help="batch size")),
    (["--print-interval"], dict(type=int, default=100, help="print interval")),
    (["--visualize"], dict(action="store_true", default=False, help="visualize using tensorboard")),
    (["--no-cuda"], dict(action="store_true", default=False, help="disables the accelerator (runs on CPU)")),
    # TPU-native extensions
    (["--bf16"], dict(action="store_true", default=False, help="bfloat16 conv compute on TPU")),
    (["--fast-grads"], dict(action="store_true", default=False, dest="fast_grads",
                            help="differentiate only trainable params (skips backward through "
                                 "frozen stages; clip norm covers trainable grads only)")),
    (["--hoist-prefix"], dict(action="store_true", default=False,
                              dest="hoist_prefix",
                              help="with --fast-grads: compute the frozen "
                                   "generator prefix once per GAN iteration "
                                   "and reuse it across the critic/generator "
                                   "steps (gradient-exact; measured a no-op "
                                   "— XLA CSE already dedups it)")),
    (["--fused-forwards"], dict(action="store_true", default=False, dest="fused_forwards",
                                help="batch the rec+rand generator forwards in the GAN step "
                                     "(BatchNorm stats over the combined batch)")),
    (["--wpack"], dict(action="store_true", default=False,
                       help="width-packed conv execution at the largest scales: "
                            "fold W-pixel pairs into channels so nfc=64 convs fill "
                            "full 128-wide MXU tiles (numerically equivalent; "
                            "~1.3x per conv at 162px+)")),
    (["--pconv"], dict(action="store_true", default=False,
                       help="route the critic's qualifying 3x3x3 C=64 convs "
                            "through the packed-lane Pallas kernel (fwd + "
                            "input-grad in VMEM; ops/pallas/conv3d_pack.py); "
                            "the WGAN-GP term keeps XLA's double-backprop")),
    (["--pconv-all"], dict(action="store_true", default=False, dest="pconv_all",
                           help="also route generator-stage convs through the "
                                "packed kernel (measured slower at scale 9 — "
                                "expert/experiment knob)")),
    (["--pfuse"], dict(action="store_true", default=False,
                       help="fuse consecutive critic-body conv+lrelu PAIRS "
                            "into one Pallas kernel with the intermediate "
                            "activation resident in VMEM (no inter-conv HBM "
                            "round-trip; ops/pallas/conv3d_fuse.py); the "
                            "WGAN-GP term keeps XLA's double-backprop")),
    (["--host-loader"], dict(action="store_true", default=False,
                             dest="host_loader",
                             help="feed batches through the prefetching "
                                  "host pipeline instead of the default "
                                  "device-resident frame cache (the cache "
                                  "uploads the per-scale frames once and "
                                  "crops/flips on device)")),
    (["--mesh-shape"], dict(type=str, default="", dest="mesh_shape", help="device mesh, e.g. 2x4 (data x spatial)")),
    (["--spmd"], dict(action="store_true", default=False, help="shard train step over the device mesh")),
    (["--run-dir"], dict(type=str, default="run", dest="run_dir", help="experiment tree root")),
    (["--profile-dir"], dict(type=str, default="", dest="profile_dir",
                             help="write a torch.profiler Chrome trace of "
                                  "iterations 5-15 of each scale, the "
                                  "package's spans among its kernels, to "
                                  "<dir>/scale_<s>/trace.json")),
    (["--compile-ahead"], dict(action="store_true", default=False,
                               dest="compile_ahead",
                               help="overlap the next scale's XLA "
                                    "compilation with this scale's training "
                                    "(a daemon thread pre-lowers from "
                                    "abstract shapes and warms the "
                                    "compilation cache; OOM-ladder rungs "
                                    "are discovered off the critical path)")),
    (["--scan-steps"], dict(type=int, default=1, dest="scan_steps",
                            help="run K iterations per chunk: on the card the "
                                 "scale's steps replay one CUDA graph (metrics/TB "
                                 "still every iteration)")),
    (["--remat"], dict(action="store_true", default=False,
                       help="rematerialize refinement stages and the critic "
                            "(jax.checkpoint): trades ~1/3 more FLOPs for the HBM "
                            "needed by the largest scales; auto-enabled on OOM")),
    (["--remat-blocks"], dict(action="store_true", default=False, dest="remat_blocks",
                              help="additionally nn.remat every conv block inside "
                                   "stages and the critic (finer recompute; "
                                   "auto-enabled if --remat alone still OOMs)")),
    (["--gp-chunked"], dict(action="store_true", default=False, dest="gp_chunked",
                            help="per-sample WGAN-GP double-backprop via lax.map "
                                 "(divides the GP HBM peak by the batch size; "
                                 "auto-enabled if remat alone still OOMs)")),
    (["--distributed"], dict(action="store_true", default=False,
                             help="this process is one rank of a torch.distributed "
                                  "launch named by HPVAEGAN_COORDINATOR, "
                                  "HPVAEGAN_NUM_PROCESSES, HPVAEGAN_PROCESS_ID")),
    (["--watchdog"], dict(type=float, default=0.0,
                          help="exit 75 (EX_TEMPFAIL) if no training chunk "
                               "completes for this many seconds — converts "
                               "silent TPU-relay wedges into clean exits "
                               "resumable via --netG (0 = off; pick a value "
                               "above the cold-compile time, e.g. 1200)")),
    (["--save-interval"], dict(type=int, default=0, dest="save_interval",
                               help="write an intra-scale checkpoint "
                                    "(netG_mid: generator + critic + both "
                                    "optimizer states + iteration) every N "
                                    "iterations; resume with --netG "
                                    ".../netG_mid restores mid-scale instead "
                                    "of replaying the whole scale (0 = "
                                    "end-of-scale checkpoints only)")),
]

_VIDEO_FLAGS = [
    (["--video-path"], dict(required=True, help="video path")),
    (["--start-frame"], dict(default=0, type=int, help="start frame number")),
    (["--max-frames"], dict(default=1000, type=int, help="# frames to save")),
    (["--sampling-rates"], dict(type=int, nargs="+", default=[4, 3, 2, 1], help="sampling rates")),
    (["--stop-scale-time"], dict(type=int, default=-1)),
    (["--decode-ahead"], dict(action="store_true", default=False,
                              dest="decode_ahead",
                              help="overlap the next scale's full-video "
                                   "re-decode with this scale's training "
                                   "(host daemon thread; holds one extra "
                                   "scale's frame store in RAM)")),
]

_GAN_EXTRA_FLAGS = [
    (["--grad-clip"], dict(type=float, default=5, help="gradient clip")),
    (["--const-amp"], dict(action="store_true", default=False, help="constant noise amplitude")),
    (["--train-all"], dict(action="store_true", default=False, help="train all levels w.r.t. train-depth")),
    (["--kl-weight"], dict(type=float, default=1.0, help="KL loss weight")),
    (["--generator"], dict(type=str, default="GeneratorHPVAEGAN", help="generator model")),
]

_BASELINES_FLAGS = [
    (["--generator"], dict(type=str, default="GeneratorCSG", help="generator model")),
    (["--nc-z"], dict(type=int, default=3, help="noise # channels")),
    (["--Gsteps"], dict(type=int, default=1, help="generator inner steps")),
    (["--Dsteps"], dict(type=int, default=1, help="discriminator inner steps")),
    (["--alpha"], dict(type=float, default=10.0, help="reconstruction loss weight")),
]


def build_parser(kind: str) -> argparse.ArgumentParser:
    """kind in {'image', 'video', 'video_baselines'} — mirrors the three
    reference entry-point parsers flag-for-flag, plus TPU extensions."""
    parser = argparse.ArgumentParser()
    for flags, kw in _COMMON_FLAGS:
        parser.add_argument(*flags, **kw)

    if kind == "image":
        parser.add_argument("--image-path", required=True, help="image path")
        parser.add_argument("--tag", default="", help="neptune tag")
        parser.add_argument("--discriminator", type=str, default="WDiscriminator2D")
        # parsed-but-unused for images in the reference too (train_image.py:321)
        parser.add_argument("--stop-scale-time", type=int, default=-1)
        for flags, kw in _GAN_EXTRA_FLAGS:
            parser.add_argument(*flags, **kw)
        parser.set_defaults(data_rep=1000)  # train_image.py:322 default
    elif kind == "video":
        parser.add_argument("--discriminator", type=str, default="WDiscriminator3D")
        for flags, kw in _VIDEO_FLAGS + _GAN_EXTRA_FLAGS:
            parser.add_argument(*flags, **kw)
    elif kind == "video_baselines":
        # reference default is the SN critic, NOT WDiscriminatorBaselines
        # (train_video_baselines.py:233)
        parser.add_argument("--discriminator", type=str, default="WDiscriminator3D")
        for flags, kw in _VIDEO_FLAGS + _BASELINES_FLAGS:
            parser.add_argument(*flags, **kw)
        parser.add_argument("--grad-clip", type=float, default=5)
        parser.add_argument("--const-amp", action="store_true", default=False)
        parser.add_argument("--train-all", action="store_true", default=False)
        parser.add_argument("--kl-weight", type=float, default=1.0)
    else:
        raise ValueError(f"unknown parser kind: {kind}")
    return parser


def config_from_args(args: argparse.Namespace) -> Config:
    cfg = Config()
    for key, value in vars(args).items():
        attr = key.replace("-", "_")
        if hasattr(cfg, attr):
            if attr == "sampling_rates":
                value = tuple(value)
            setattr(cfg, attr, value)
    return cfg
