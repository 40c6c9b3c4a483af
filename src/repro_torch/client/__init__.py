# First-class Python SDK for the coreset service's v1 API.  Typed requests/
# responses (repro_torch.service.protocol dataclasses — no raw dicts), binary/JSON
# encoding negotiation, and bounded retries over stdlib urllib.
from .client import (AdmissionRejectedError, CoresetAPIError, CoresetClient,
                     TransportError)

__all__ = ["CoresetClient", "CoresetAPIError", "TransportError",
           "AdmissionRejectedError"]
