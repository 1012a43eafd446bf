"""Data: the synthetic measures of the paper's experiments
(`repro_torch.data.pointclouds`), the echocardiogram videos of its Table 1
(`repro_torch.data.echo`) and the LM token stream (`TokenPipeline`); the
names of the reference's ``repro.data``. Stateless and seed-addressed."""
from repro_torch.data.echo import synth_echo_video
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.data.pointclouds import make_measures, make_uot_measures, wfr_eta_for_density

__all__ = [
    "TokenPipeline",
    "make_measures",
    "make_uot_measures",
    "synth_echo_video",
    "wfr_eta_for_density",
]
