r"""The topics of the six paper modules wired onto the topic bus, plus the
cloud back-end (speed training + archiving), reproducing Fig. 4's
orchestration:

  stream -> data_injection --(stream topic)--> batch/speed inference (async)
                               |                    \-> hybrid inference
                               |--> data_sync -> archiving (cloud)
                               \--> speed_training -> model publish
  model publish --(model topic)--> model_sync (edge) -> next-window speed model

``BusExecutor`` subscribes the stages to these topics.  The reference's
calibrated simulation (``EdgeCloudSimulation``) comes with the slice that
ports the launcher's calibrated mode.
"""

T_STREAM = "stream/window"
T_BATCH = "results/batch"
T_SPEED = "results/speed"
T_HYBRID = "results/hybrid"
T_MODEL = "model/latest"
