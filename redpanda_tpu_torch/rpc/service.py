"""RPC service definitions.

The reference generates a service base class + client protocol + per-method
failure probes from JSON schemas (tools/rpcgen.py). Here a ``ServiceDef`` is
declared inline: methods carry serde codecs for request/response, and method
ids follow the same scheme — ``crc32(namespace:service) ^ crc32(method-key)``
(rpcgen.py:226-236) — so ids are stable across processes.

``Client(stub)`` objects expose one async callable per method;
``ServiceHandler`` dispatches ids to a bound implementation and runs the
honey-badger probe registered per method (rpcgen.py:159-165).

(The JAX package's rpc/service.py, copied.)
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

from redpanda_tpu_torch.finjector import honey_badger


@dataclass(frozen=True)
class MethodDef:
    name: str
    request: object  # serde Struct/Envelope
    response: object
    id: int = 0  # filled by ServiceDef


class ServiceDef:
    def __init__(self, namespace: str, name: str, methods: list[MethodDef]):
        self.namespace = namespace
        self.name = name
        self.id = zlib.crc32(f"{namespace}:{name}".encode())
        self.methods: dict[str, MethodDef] = {}
        self.by_id: dict[int, MethodDef] = {}
        for m in methods:
            mid = self.id ^ zlib.crc32(f"{m.name}:{namespace}".encode())
            bound = MethodDef(m.name, m.request, m.response, mid & 0xFFFFFFFF)
            self.methods[m.name] = bound
            self.by_id[bound.id] = bound
        honey_badger.register_probe(name, *self.methods.keys())


class ServiceHandler:
    """Binds a ServiceDef to an implementation object.

    The implementation provides ``async def <method>(self, request: dict)``
    for each method; dispatch decodes/encodes via the method codecs.
    """

    def __init__(self, definition: ServiceDef, impl) -> None:
        self.definition = definition
        self.impl = impl

    def method_ids(self):
        return self.definition.by_id.keys()

    async def dispatch(self, method_id: int, payload: bytes) -> bytes:
        m = self.definition.by_id[method_id]
        await honey_badger.maybe_inject(self.definition.name, m.name)
        request = m.request.decode(payload)
        response = await getattr(self.impl, m.name)(request)
        return m.response.encode(response)


class Client:
    """Per-service async client over an rpc transport.

    ``await client.method_name(request_dict)`` → response dict. Mirrors the
    generated ``client_protocol`` classes.
    """

    def __init__(self, definition: ServiceDef, transport) -> None:
        self._definition = definition
        self._transport = transport

    def __getattr__(self, name: str):
        m = self._definition.methods.get(name)
        if m is None:
            raise AttributeError(name)

        async def call(request: dict, timeout: float | None = None) -> dict:
            payload = m.request.encode(request)
            raw = await self._transport.send(m.id, payload, timeout=timeout)
            return m.response.decode(raw)

        return call
