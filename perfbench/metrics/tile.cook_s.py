"""Seconds to cook one whole tile alone: ``predict.tile_loader`` iterated
over the tile's points (subtiles, features, GridSampling, x-sort,
normalizations, padding), after the window, on the host clock."""


def read(record):
    return record.get("cook_s")
