r"""The topics of the six paper modules wired onto the topic bus, plus the
cloud back-end (speed training + archiving), reproducing Fig. 4's
orchestration:

  stream -> data_injection --(stream topic)--> batch/speed inference (async)
                               |                    \-> hybrid inference
                               |--> data_sync -> archiving (cloud)
                               \--> speed_training -> model publish
  model publish --(model topic)--> model_sync (edge) -> next-window speed model

``BusExecutor`` subscribes the stages to these topics; the fleet executor
multiplexes them per stream (``stream_topic``) and adds ``T_RESYNC``, the
sync site's re-request of a model whose checksum failed, the request plane's
``T_REQUEST`` and ``T_RESPONSE``, and the placement controller's beat
``T_CTRL``.  The reference's
calibrated simulation (``EdgeCloudSimulation``) comes with the slice that
ports the launcher's calibrated mode.
"""

T_STREAM = "stream/window"
T_BATCH = "results/batch"
T_SPEED = "results/speed"
T_HYBRID = "results/hybrid"
T_MODEL = "model/latest"
T_RESYNC = "model/rerequest"
T_REQUEST = "serve/request"
T_RESPONSE = "serve/response"
T_CTRL = "ctrl/tick"  # the elastic placement controller's control-plane beat


def stream_topic(base: str, stream_id: str) -> str:
    """Per-stream multiplexing of a base topic: ``stream/window`` ->
    ``stream/window/t03``.  Fleet executors subscribe ``base + "/+"`` (the
    bus's single-level wildcard) to receive every stream of a fleet with
    one subscription."""
    return f"{base}/{stream_id}"
