"""Example configurations.

Counterparts of the reference's ``avod/configs/*.config`` text-format files:
``pyramid_cars_with_aug_example.config``, the pedestrian/cyclist config, and
the hermetic unit-test config used with the vendored mini-KITTI fixture.
"""

from __future__ import annotations

import dataclasses

from sparse_pooling_tpu_torch.configs.config import (
    AnchorConfig,
    AvodStage2Config,
    BackboneConfig,
    BevConfig,
    DatasetConfig,
    EvalConfig,
    ImageConfig,
    MiniBatchConfig,
    ContfuseModelConfig,
    ModelConfig,
    Mv3dModelConfig,
    PipelineConfig,
    RpnConfig,
    SparsePoolConfig,
    TrainConfig,
)

# KITTI per-class anchor sizes (l, w, h): cluster centroids of GT dimensions,
# the role played by the reference's label_cluster_utils output.
CAR_SIZE = (3.913, 1.629, 1.526)
PEDESTRIAN_SIZE = (0.842, 0.660, 1.760)
CYCLIST_SIZE = (1.763, 0.597, 1.737)


def cars_pyramid_config() -> PipelineConfig:
    """Cars, VGG pyramid, SHPL fusion, flip+PCA augmentation."""

    return PipelineConfig(
        checkpoint_name="pyramid_cars_shpl",
        model=ModelConfig(
            classes=("Car",),
            anchors=AnchorConfig(sizes=(CAR_SIZE,)),
            # 4x4-position-block anchor filtering: the RPN ROI crops share
            # one window per block — 65.1 -> 74.4 (Q=2) -> 80.3 (Q=4) fps/chip (the
            # crop gather is descriptor-bound). Proposal-set parity with
            # per-position filtering is exact when the cap does not
            # overflow (tests); under overflow both paths keep the
            # densest-count tiers first, so objects survive either way.
            # Overflow IS the common case at this lattice (~950 nonempty
            # Q4-blocks vs the 512-block cap). Round-4 certification under
            # the sharpened oracle at HIGH-RESOLUTION val (48 held-out
            # hard frames, 2 seeds, 40-pt): Q=4 3D moderate 0.908/0.893
            # vs Q=1 0.855/0.840 — quad filtering is AP-POSITIVE (+0.053
            # at ~0.02 seed spreads; block-granular keeps retain clustered
            # mid-IoU positions that position-granular capping drops), and
            # the cap drops NO anchors within 1 m of counted GT (25/26
            # covered both modes; the miss is outside every scoring band).
            # eval_nms_size 128 (reference: 300): the stage-2 proposal
            # count is the one semantic perf lever that survived round-5
            # pricing — bench 133.16 -> 145.51 fps/chip (+9.3%) at batch
            # 48, and re-scoring the SAME certified checkpoints under
            # P=128 (tools/price_eval_nms.py, eval-only so no retraining
            # bias, 48-val hard scenes, seeds 0/7) moves moderate
            # 2d/bev/3d/aos by <= 0.001 at every checkpoint (0.916/0.899
            # and 0.895/0.923 3D — identical to 3 decimals). 128 is still
            # ~5x the 15-25 objects/frame of the hard scenes. Training
            # keeps train_nms_size=1024 (loss-side sampling unchanged);
            # set 300 for reference-exact eval semantics.
            rpn=RpnConfig(roi_quad=4, eval_nms_size=128),
            # Stage 2 samples BOTH views reference-exact (stride 1).
            # History: round 3 shipped bev_roi_stride=4 (patch-einsum ROI,
            # 1.02 -> 0.65 ms/frame) certified by a check pinned at the
            # 11-point ceiling ("0.902 vs 0.909 — run noise"). Round 4's
            # SHARPENED oracle (cars_hard scenes, 40-pt, per-band)
            # re-decided it: exact crops score 3D moderate 0.979/0.972
            # across two seeds vs 0.890/0.953 strided — consistently
            # higher AND 10x lower seed variance (strided's block-shared
            # window degrades hard-band localization). The ~0.4 ms/frame
            # cost is the right trade for the flagship default; stride 4
            # remains available via avod.bev_roi_stride for
            # throughput-first deployments (A/B: cars_check
            # --s2_bev_stride). The IMAGE view was already exact: striding
            # it cost 0.909 -> 0.791 moderate BEV/3D at stride 4 (near
            # boxes collapse to a 16-cell context crop).
            avod=AvodStage2Config(
                bev_roi_stride=1, img_roi_stride=1, roi_patch=16
            ),
        ),
    )


def rcnn_cars_config() -> PipelineConfig:
    """Cars with the MV3D-style FusionRcnn (the second consumer family)."""

    return PipelineConfig(
        checkpoint_name="rcnn_cars_shpl",
        model=ModelConfig(
            architecture="rcnn",
            classes=("Car",),
            anchors=AnchorConfig(sizes=(CAR_SIZE,)),
            # stage-2 regression: the family historically shipped plain
            # 6-d anchor offsets; box_4c/box_8c (MV3D's corner fidelity)
            # are wired and A/B-able via cars_check --rcnn_box_rep
            # (round-4 verdict item 3)
            avod=AvodStage2Config(box_rep="offsets"),
        ),
    )


def mv3d_cars_config() -> PipelineConfig:
    """Cars with MV3D as published (Chen et al., arXiv:1611.07759): BEV
    (five height slices, density, intensity), LiDAR front view and image,
    each through VGG-16 at half width without pool4 (the (32, 64, 128, 256)
    encoder, stride 8); SHPL fusion of BEV and image both ways, as the
    reference's MV3D fork grafts it; the proposal head on the 2x upsampled
    fused BEV map (stride 4) with MV3D's four anchors a cell and the empty
    ones masked, NMS at 0.7 keeping 300; 7x7 crops of each view's stride-8
    map, deep fusion by the element-wise mean over three FC layers of 2048;
    box_8c. The image canvas is KITTI's 375x1242 upscaled to a short side of
    500 (504x1656, a multiple of the stride)."""

    return PipelineConfig(
        checkpoint_name="mv3d_cars_shpl",
        model=Mv3dModelConfig(
            architecture="mv3d",
            classes=("Car",),
            image=ImageConfig(height=504, width=1656),
            # (l, w) in {(3.9, 1.6), (1.0, 0.6)}, h = 1.56, at 0 and 90 deg,
            # on the proposal lattice (0.1 m voxels x stride 4)
            anchors=AnchorConfig(stride=0.4, sizes=((3.9, 1.6, 1.56), (1.0, 0.6, 1.56))),
            # Faster R-CNN's test default of 6000 boxes before the NMS
            rpn=RpnConfig(nms_iou_thresh=0.7, eval_nms_size=300, pre_nms_top_k=6000),
            avod=AvodStage2Config(fusion_type="deep", box_rep="box_8c"),
        ),
    )


def contfuse_cars_config() -> PipelineConfig:
    """Cars with ContFuse (Liang et al., ECCV 2018): PIXOR's BEV occupancy
    (0.1 m voxels over the 704x800 lattice, 35 height levels and the
    reflectance) through a plain group of two 32-wide convs and four residual
    groups of 4, 8, 12 and 12 convs (64, 128, 192, 256 wide), each group fed
    by a continuous-fusion layer from the ResNet-18 image stream's combined
    features at each BEV pixel's 3 nearest LiDAR points; a top-down path to
    1/4 resolution and a 1x1 header, two anchors (0 and 90 deg) a cell, one
    stage; per-class NMS at 0.1 keeping 100. The 384x1248 canvas of the rcnn
    preset."""

    return PipelineConfig(
        checkpoint_name="contfuse_cars",
        model=ContfuseModelConfig(
            architecture="contfuse",
            classes=("Car",),
            # (l, w, h) of a car at 0 and 90 deg on the header's lattice (0.1 m voxels x stride 4)
            anchors=AnchorConfig(stride=0.4, sizes=(CAR_SIZE,)),
            avod=AvodStage2Config(nms_iou_thresh=0.1, nms_size=100),
        ),
    )


def people_pyramid_config() -> PipelineConfig:
    """Pedestrian + Cyclist, shared config (reference people config)."""

    return PipelineConfig(
        checkpoint_name="pyramid_people_shpl",
        model=ModelConfig(
            classes=("Pedestrian", "Cyclist"),
            anchors=AnchorConfig(
                sizes=(PEDESTRIAN_SIZE, CYCLIST_SIZE),
                # people configs use a finer anchor stride in the reference
                stride=0.3,
            ),
            mini_batch=MiniBatchConfig(
                rpn_neg_iou=(0.0, 0.3),
                rpn_pos_iou=(0.45, 1.0),
                avod_neg_iou=(0.0, 0.45),
                avod_pos_iou=(0.55, 1.0),
            ),
            # finer ROI pooling: pedestrians/cyclists are ~0.6-0.8 m wide,
            # so the car default of 0.8 m avg-pool cells would wash them
            # out. Capped path: the people grid (0.3 m stride, 4 variants)
            # is ~250k dense anchors, so the tier-compacted cap keeps the
            # RPN tractable. roi_quad=4 (4x4-position blocks over the
            # padded 233x267 grid — non-divisible dims pad with
            # never-kept empties): measured 81.0 -> 108.8 fps/chip at
            # batch 48 (Q2: 104.5) with held-out production-geometry AP
            # IDENTICAL to Q1 (Ped 0.909/0.909/0.909, Cyc 1.000/1.000/
            # 1.000 — people_prod_check --roi_quad 4, 3000 steps, TPU,
            # 2026-08-19). Same cap-overflow semantics as cars: densest
            # count tiers kept first.
            rpn=RpnConfig(
                bev_roi_stride=4, img_roi_stride=4, dense_grid=False,
                roi_quad=4,
            ),
        ),
    )


def unittest_config(dataset_root: str = "tests/fixtures/kitti") -> PipelineConfig:
    """Tiny hermetic config for unit tests (reference: unittest_pipeline.config).

    Shrinks every static dimension so the whole model traces/compiles fast
    on the CPU backend: an 88x100 BEV lattice, 48x160 image canvas, tiny
    backbone, tiny caps.
    """

    bev = BevConfig(voxel_size=0.8, pad_h=0)  # 70/0.8 -> 88 (rounded) x 100
    return PipelineConfig(
        checkpoint_name="unittest_pipeline",
        model=ModelConfig(
            classes=("Car",),
            bev=bev,
            image=ImageConfig(height=48, width=160),
            # fusion_stride must equal the encoder's final stride
            # 2^(len(backbone.channels) - 1): 2 stages -> stride 2
            sparse_pool=SparsePoolConfig(
                fusion_stride=2, ell_k=4, max_points=1024
            ),
            anchors=AnchorConfig(
                sizes=(CAR_SIZE,), stride=4.0, max_anchors=128
            ),
            mini_batch=MiniBatchConfig(rpn_batch_size=32, avod_batch_size=32),
            backbone=BackboneConfig(
                channels=(8, 16), blocks=(1, 1), out_channels=8,
                compute_dtype="float32", decode_stride=1,
                space_to_depth=False,
            ),
            rpn=RpnConfig(
                fusion_channels=32,
                pre_nms_top_k=64,
                train_nms_size=16,
                eval_nms_size=16,
                # reference-exact full-res crops; the strided patch-einsum
                # path gets its own coverage in test_model
                bev_roi_stride=1,
                img_roi_stride=1,
                # capped path at test scale (the dense-grid path gets its
                # own parity tests + the flagship bench/dryrun coverage)
                dense_grid=False,
            ),
            avod=AvodStage2Config(fc_layers=(32, 32), nms_size=8),
        ),
        train=TrainConfig(
            batch_size=1, max_iterations=2, checkpoint_interval=1,
            summary_interval=1,
        ),
        eval=EvalConfig(batch_size=2),
        dataset=DatasetConfig(root=dataset_root, aug_flip=False, aug_pca_jitter=False, shuffle=False),
    )


def preset(name: str) -> PipelineConfig:
    presets = {
        "cars": cars_pyramid_config,
        "rcnn_cars": rcnn_cars_config,
        "mv3d_cars": mv3d_cars_config,
        "contfuse_cars": contfuse_cars_config,
        "people": people_pyramid_config,
        "unittest": unittest_config,
    }
    if name not in presets:
        raise KeyError(f"unknown preset '{name}'; options: {sorted(presets)}")
    return presets[name]()


def override(cfg: PipelineConfig, **kwargs) -> PipelineConfig:
    """Shallow dataclasses.replace passthrough for CLI overrides."""

    return dataclasses.replace(cfg, **kwargs)
