"""Render saved predictions over images and BEV maps.

    python -m sparse_pooling_tpu_torch.demos.show_predictions \
        --dataset_root <kitti_root> --pred_dir <dir with %06d.txt> --out_dir out [--draw_gt]

Port of ``sparse_pooling_tpu.demos.show_predictions`` (capability parity
with the reference's ``demos/show_predictions_2d.py``): read KITTI-format
prediction txts (from ``run_inference`` / ``run_evaluation``), draw 3D
wireframes on the camera image and footprints on the BEV density map
(``data.bev``), save ``<sid>_image.png`` and ``<sid>_bev.png``. Host only:
the image is read by the native loader (``native.sample_loader.decode_png``)
and the PNGs written by ``data.synthetic.encode_png``; nothing touches a
card.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--data_dir", default="training")
    p.add_argument("--pred_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--score_threshold", type=float, default=0.1)
    p.add_argument("--draw_gt", action="store_true")
    args = p.parse_args(argv)

    from sparse_pooling_tpu_torch.configs.config import AreaExtents, BevConfig
    from sparse_pooling_tpu_torch.data import bev as bev_mod
    from sparse_pooling_tpu_torch.data import calib as calib_mod
    from sparse_pooling_tpu_torch.data import labels as labels_mod
    from sparse_pooling_tpu_torch.data import pointcloud
    from sparse_pooling_tpu_torch.data.synthetic import encode_png
    from sparse_pooling_tpu_torch.demos import vis_utils
    from sparse_pooling_tpu_torch.native.sample_loader import decode_png

    base = os.path.join(args.dataset_root, args.data_dir)
    os.makedirs(args.out_dir, exist_ok=True)
    ext = AreaExtents()
    bev_cfg = BevConfig()

    def save(path, img):
        with open(path, "wb") as f:
            f.write(encode_png(img))

    for fname in sorted(os.listdir(args.pred_dir)):
        if not fname.endswith(".txt"):
            continue
        sid = fname[:-4]
        preds = [ob for ob in labels_mod.read_labels(os.path.join(args.pred_dir, fname))
                 if ob.score >= args.score_threshold]
        cal = calib_mod.read_calibration(os.path.join(base, "calib", sid + ".txt"))
        image = decode_png(os.path.join(base, "image_2", sid + ".png"))
        gt = labels_mod.read_labels(os.path.join(base, "label_2", sid + ".txt")) if args.draw_gt else []

        out = vis_utils.draw_boxes_3d(image, preds, cal.p2)
        if gt:
            out = vis_utils.draw_boxes_3d(out, gt, cal.p2, color_key="gt")
        save(os.path.join(args.out_dir, sid + "_image.png"), out)

        pts = pointcloud.get_lidar_point_cloud(os.path.join(base, "velodyne", sid + ".bin"), cal, image.shape[:2])
        plane_path = os.path.join(base, "planes", sid + ".txt")
        plane = (labels_mod.read_ground_plane(plane_path) if os.path.exists(plane_path)
                 else labels_mod.default_ground_plane())
        maps = bev_mod.generate_bev_maps(pointcloud.filter_to_area_extents(pts, ext), plane, ext, bev_cfg)
        bev_img = vis_utils.render_bev(
            maps, boxes_3d=labels_mod.labels_to_box3d_array(preds),
            gt_boxes_3d=labels_mod.labels_to_box3d_array(gt) if gt else None, extents=ext,
            voxel_size=bev_cfg.voxel_size,
        )
        save(os.path.join(args.out_dir, sid + "_bev.png"), bev_img)
        print(f"[show_predictions] {sid}: {len(preds)} predictions rendered")


if __name__ == "__main__":
    main()
