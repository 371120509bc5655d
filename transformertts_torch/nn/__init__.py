"""NN modules: core primitives, masks, attention, blocks, length regulator."""
