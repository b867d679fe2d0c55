"""Python mirror of ``csrc/tc_tile.cuh``'s layout, for the launch plans of
the kernels that use it (``cheb_filter``, ``blocked_mp``, ``edge_mlp``,
``blocked_q``), a Hopper block's shared-memory limit, which every kernel
wrapper checks its plan against, and an H100's SM count."""

SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use
# streaming multiprocessors of an H100 SXM: the launch plans' default for
# the grids that hold one block an SM (the wrappers pass the card's own)
H100_SMS = 132

# floats of the shared region that holds the ring of weight stages (hi
# and lo planes of 128 x 16) during a product and the caller's epilogue
# tile after it: three stages (kTcRegion)
REGION = 3 * 2 * 128 * 16


def image_floats(kdim: int, ncols: int) -> int:
    """Floats of the split image of a ``[kdim, ncols]`` weight or series
    (``tc_image_floats``): per 128-column pass and 16 rows, a hi and a lo
    plane of 128 x 16."""
    return -(-ncols // 128) * -(-kdim // 16) * 2 * 128 * 16
