from repro_torch.data.pipeline import (TokenStream,  # noqa: F401
                                       make_batch_for, synthetic_mnist)
