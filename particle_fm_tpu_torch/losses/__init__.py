from particle_fm_tpu_torch.losses.flow_matching import cfm_loss, fm_ot_loss, get_loss_fn

__all__ = ["fm_ot_loss", "cfm_loss", "get_loss_fn"]
