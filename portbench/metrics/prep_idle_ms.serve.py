"""Device idle milliseconds a camera request while the host prepares it:
the camera patching (`closed_loop.patch_cameras`) and the rays and ground
truth (`pipeline.rays`), over the window's `render_image` spans (layer:
pipelines)."""

from portbench.harness import spans


def read(trace):
    return spans.per(trace, spans.idle_inside(trace, ("closed_loop.patch_cameras", "pipeline.rays")), "render_image")
