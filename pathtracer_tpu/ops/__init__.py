"""Device compute ops: intersection, the bounce loop, wavefront pipeline,
and the Pallas GPU megakernel."""
