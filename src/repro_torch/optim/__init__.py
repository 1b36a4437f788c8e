from repro_torch.optim.optimizers import Optimizer, adam, apply_updates

__all__ = ["Optimizer", "adam", "apply_updates"]
