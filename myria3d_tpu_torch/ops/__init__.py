"""Device ops: neighbour search, interpolation, decimation, fused LFA."""
