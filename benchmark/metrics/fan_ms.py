"""fan_ms: device ms a call of the operations launched inside the
'fan' layer's forward and backward marks (``trace.py``), over the
traced calls."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace.layer_ms('fan')
