"""Family `splatad_train` in the CPU tests: its tiny sizes, and the port
faults planted in `SplatADPipeline`, `SplatADModel` and the camera
composite's backward."""

from __future__ import annotations


def tiny(c: dict) -> dict:
    """4,096 gaussians, 64 slots a camera tile, 20 x 14-degree lidar tiles of
    32 slots and 64 points (54 tiles), scans padded to 1,024 points; training
    still starts one step before a refine (`train.start_step`)."""
    c["cap_max"] = 4096
    t = c["train"]
    t["cap_max"] = 4096
    t["mcmc"] = dict(t["mcmc"], cap_max=4096)
    t["model"] = dict(t["model"], max_per_tile=64, lidar_tile_azim=20.0, lidar_tile_elev=14.0, lidar_max_per_tile=32,
                      lidar_pts_per_tile=64)
    t["datamanager"] = dict(t["datamanager"], max_lidar_points=1024)
    return c


# The full size's limits hold at the tiny size. On the CPU the port's composites run their plain forward and the
# hand-derived backward, the reference autograd through the plain forward; the checked steps are a frame, a scan and
# a frame, as at the full size. Over seeds 2**31 + 11, 3 and 5 the port reads loss_rel <= 3.0e-5, grad_gap <= 8.9e-5
# and change_gap <= 1.4e-3; the control (fp8 decoders, bf16 gaussians) loss_rel >= 0.088, grad_gap >= 0.94 and
# change_gap >= 0.98; half the frame or scan loss_rel >= 0.36, grad_gap >= 0.20 and change_gap >= 0.064; K3 over half
# the frame's tiles (`camera_backward_altered`) grad_gap >= 0.43.
LIMITS: dict = {}


def step_unchanged(monkeypatch) -> None:
    """The step computes its loss and leaves the parameters as they were."""
    from neurad_tpu_torch.pipelines.splatad_pipeline import SplatADPipeline

    def unchanged(self, state, sample):
        if hasattr(sample, "image"):
            sample = self._downscale_sample(sample, state.step)
        total, metrics, _ = self._forward_loss(sample)
        state.step += 1
        return state, dict({k: v.detach() for k, v in metrics.items()}, total_loss=total.detach())

    monkeypatch.setattr(SplatADPipeline, "train_step", unchanged)


def half_batch(monkeypatch) -> None:
    """The step takes the loss of the top half of the frame's rows, or of the
    first half of the scan's valid points."""
    from neurad_tpu_torch.models.splatad import SplatADModel
    from portbench.reference.splatad_train import half_valid  # the reference's own "half" fault, on the scan

    camera_loss, lidar_loss = SplatADModel.camera_loss, SplatADModel.lidar_loss

    def half_camera(self, outputs, gt_image):
        rows = outputs["rgb"].shape[0] // 2
        return camera_loss(self, dict(outputs, rgb=outputs["rgb"][:rows]), gt_image[:rows])

    def half_lidar(self, outputs, raster_pts, did_return, valid):
        return lidar_loss(self, outputs, raster_pts, did_return, half_valid(valid))

    monkeypatch.setattr(SplatADModel, "camera_loss", half_camera)
    monkeypatch.setattr(SplatADModel, "lidar_loss", half_lidar)


def camera_backward_altered(monkeypatch) -> None:
    """K3 (the camera composite's backward) takes the gradients of the first
    half of the frame's tiles only, as a launch over half its grid would: the
    forward, the loss and the lidar's passes are the port's own."""
    import torch

    from neurad_tpu_torch.ops import tile_composite

    camera_backward = tile_composite._camera_backward

    def half_tiles(table, tile_gauss, tile_valid, pix, times, feat, depth, alpha, g_feat, g_depth, g_alpha):
        keep = (torch.arange(g_feat.shape[0], device=g_feat.device) < g_feat.shape[0] // 2).view(-1, 1, 1)
        g_feat, g_depth, g_alpha = (torch.where(keep, g, torch.zeros_like(g)) for g in (g_feat, g_depth, g_alpha))
        return camera_backward(table, tile_gauss, tile_valid, pix, times, feat, depth, alpha, g_feat, g_depth, g_alpha)

    monkeypatch.setattr(tile_composite, "_camera_backward", half_tiles)
