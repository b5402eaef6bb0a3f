"""The "Render" scope a frame, in ms: the host's time issuing one frame
(``Renderer.render_adaptive``: selection, vertex stage, setup, binning,
the raster calls, lighting and the copies behind them), over the window's
loops."""


def read(run):
    frames = sum(loop.frames for loop in run.loops)
    if not frames:
        return None
    return 1e3 * sum(loop.render_s for loop in run.loops) / frames
