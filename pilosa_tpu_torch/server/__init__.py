"""HTTP server, API facade, wire codec, and configuration.

Keeps the reference's public HTTP surface (reference http/handler.go:274
route table) so existing Pilosa client libraries work: JSON bodies/query
strings where the reference uses them, and the protobuf wire format for
import endpoints (hand-rolled codec matching internal/public.proto field
numbers — the wire contract, not the generated code).
"""

from pilosa_tpu_torch.server.api import API, APIError
from pilosa_tpu_torch.server.http import Server
