"""Cells cut to a size the CPU runs in seconds, for the tests: the same
files, fewer widths, rays, samples, views and pixels."""

from __future__ import annotations

from nerfbench import spec


def small_cell(name: str) -> spec.Cell:
    cell = spec.find(name)
    cfg = cell.config
    if cfg["reference"] == "nerf":
        cfg.update({"network.feat_dim": 64, "renderer.num_samples_coarse": 16, "renderer.num_samples_fine": 16})
    else:
        cfg.update({"network.num_level": 4, "network.log_max_entry_per_level": 10, "network.max_res": 64,
                    "renderer.num_samples_coarse": 16})
    cfg["renderer.num_pixels"] = 64
    cfg["scene"].update({"train_views": 3, "train_size": 16, "test_views": 2, "test_size": 32, "image_samples": 8})
    cell.traffic.update({"chunk_size": 256, "checked_chunks": 4, "reference_block": 64})
    return cell
