from repro_torch.quant.linear import embed, linear, tied_head, tied_logits

__all__ = ["embed", "linear", "tied_head", "tied_logits"]
