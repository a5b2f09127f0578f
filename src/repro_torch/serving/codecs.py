"""TD4 'Communication protocol': REST/JSON vs gRPC/binary wire codecs.

No sockets in this container, so the decision is realized where its cost
actually lives: serialization.  ``JsonCodec`` is the REST path (UTF-8 JSON,
human-readable, interoperable); ``BinaryCodec`` is the gRPC/protobuf path
(length-prefixed packed little-endian).  Benchmarks measure bytes-on-wire and
encode/decode wall time — the quality characteristics the paper found
unstudied for this decision.
"""

from __future__ import annotations

import json
import struct
from typing import Tuple

import numpy as np


class JsonCodec:
    name = "rest_json"
    content_type = "application/json"

    def encode_request(self, rid: int, tokens: np.ndarray,
                       max_new_tokens: int) -> bytes:
        return json.dumps(
            {
                "id": rid,
                "inputs": [int(t) for t in tokens],
                "max_new_tokens": max_new_tokens,
            }
        ).encode("utf-8")

    def decode_request(self, data: bytes) -> Tuple[int, np.ndarray, int]:
        obj = json.loads(data.decode("utf-8"))
        return (
            obj["id"],
            np.asarray(obj["inputs"], np.int32),
            obj["max_new_tokens"],
        )

    def encode_response(self, rid: int, tokens: np.ndarray) -> bytes:
        return json.dumps(
            {"id": rid, "outputs": [int(t) for t in tokens]}
        ).encode("utf-8")

    def decode_response(self, data: bytes) -> Tuple[int, np.ndarray]:
        obj = json.loads(data.decode("utf-8"))
        return obj["id"], np.asarray(obj["outputs"], np.int32)


class BinaryCodec:
    name = "grpc_binary"
    content_type = "application/grpc+binary"
    _REQ = struct.Struct("<IIH")   # rid, n_tokens, max_new
    _RSP = struct.Struct("<II")    # rid, n_tokens

    def encode_request(self, rid: int, tokens: np.ndarray,
                       max_new_tokens: int) -> bytes:
        t = np.ascontiguousarray(tokens, np.int32)
        return self._REQ.pack(rid, len(t), max_new_tokens) + t.tobytes()

    def decode_request(self, data: bytes) -> Tuple[int, np.ndarray, int]:
        rid, n, max_new = self._REQ.unpack_from(data, 0)
        tokens = np.frombuffer(data, np.int32, count=n, offset=self._REQ.size)
        return rid, tokens, max_new

    def encode_response(self, rid: int, tokens: np.ndarray) -> bytes:
        t = np.ascontiguousarray(tokens, np.int32)
        return self._RSP.pack(rid, len(t)) + t.tobytes()

    def decode_response(self, data: bytes) -> Tuple[int, np.ndarray]:
        rid, n = self._RSP.unpack_from(data, 0)
        return rid, np.frombuffer(data, np.int32, count=n, offset=self._RSP.size)


def make_codec(name: str):
    if name in ("rest_json", "json"):
        return JsonCodec()
    if name in ("grpc_binary", "binary"):
        return BinaryCodec()
    raise ValueError(name)
