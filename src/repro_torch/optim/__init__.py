from repro_torch.optim.adamw import (AdamWState, adamw,  # noqa: F401
                                     clip_by_global_norm, cosine_schedule,
                                     sgd)
from repro_torch.optim.compress import (compress_gradients,  # noqa: F401
                                        compressed_bytes,
                                        decompress_gradients)
