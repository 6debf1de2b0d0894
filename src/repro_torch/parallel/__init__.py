from repro_torch.parallel.collectives import (accounting, all_gather,
                                              axis_index, axis_size, psum,
                                              replicate)

__all__ = ["accounting", "all_gather", "axis_index", "axis_size", "psum",
           "replicate"]
