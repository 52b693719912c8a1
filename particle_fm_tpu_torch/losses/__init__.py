from particle_fm_tpu_torch.losses.flow_matching import (cfm_loss, cfm_ot_loss, diffusion_loss,
                                                       droid_loss, fm_ot_loss, get_loss_fn,
                                                       reflow_loss)

__all__ = ["fm_ot_loss", "cfm_loss", "cfm_ot_loss", "reflow_loss", "diffusion_loss", "droid_loss",
           "get_loss_fn"]
