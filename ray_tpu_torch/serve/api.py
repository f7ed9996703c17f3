"""serve public API; port of ray_tpu/serve/api.py (reference:
python/ray/serve/api.py — serve.start :533, Client.create_endpoint :186,
create_backend :330, get_handle)."""

from __future__ import annotations

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.serve.config import BackendConfig
from ray_tpu_torch.serve.controller import ServeController
from ray_tpu_torch.serve.http_proxy import HTTPProxy
from ray_tpu_torch.serve.router import ServeHandle

_client = None


class Client:
    def __init__(self, controller, proxies=None,
                 http_port: int | None = None):
        self._controller = controller
        self._proxies = list(proxies or [])
        self._http_port = http_port
        self._handles: dict[str, ServeHandle] = {}

    @property
    def _proxy(self):  # back-compat single-proxy view
        return self._proxies[0] if self._proxies else None

    # -- backends --------------------------------------------------------

    def create_backend(self, name: str, func_or_class, *init_args,
                       config: BackendConfig | dict | None = None):
        cfg = config or BackendConfig()
        if isinstance(cfg, BackendConfig):
            cfg = cfg.to_dict()
        else:
            cfg = BackendConfig.from_dict(cfg).to_dict()
        ray_tpu_torch.get(self._controller.create_backend.remote(
            name, cloudpickle.dumps(func_or_class), tuple(init_args), cfg),
            timeout=120)

    def delete_backend(self, name: str):
        ray_tpu_torch.get(self._controller.delete_backend.remote(name),
                          timeout=60)

    def update_backend_config(self, name: str,
                              config: BackendConfig | dict):
        if isinstance(config, BackendConfig):
            config = config.to_dict()
        ray_tpu_torch.get(self._controller.update_backend_config.remote(
            name, dict(config)), timeout=120)

    def get_backend_config(self, name: str) -> BackendConfig:
        return BackendConfig.from_dict(ray_tpu_torch.get(
            self._controller.get_backend_config.remote(name), timeout=60))

    def list_backends(self) -> list[str]:
        return ray_tpu_torch.get(self._controller.list_backends.remote(),
                                 timeout=60)

    # -- endpoints -------------------------------------------------------

    def create_endpoint(self, name: str, *, backend: str,
                        route: str | None = None,
                        methods: list[str] | None = None):
        ray_tpu_torch.get(self._controller.create_endpoint.remote(
            name, backend, route, methods), timeout=60)

    def delete_endpoint(self, name: str):
        ray_tpu_torch.get(self._controller.delete_endpoint.remote(name),
                          timeout=60)

    def set_traffic(self, endpoint: str, traffic: dict):
        """Split an endpoint's traffic across backends by weight —
        the canary/rollout primitive (reference: serve/api.py
        set_traffic). Weights normalize: {"v1": 0.9, "v2": 0.1}."""
        ray_tpu_torch.get(self._controller.set_traffic.remote(
            endpoint, dict(traffic)), timeout=60)

    def shadow_traffic(self, endpoint: str, backend: str,
                       proportion: float):
        """Mirror `proportion` of the endpoint's requests to `backend`,
        dropping results (reference: serve/api.py shadow_traffic);
        proportion=0 stops shadowing."""
        ray_tpu_torch.get(self._controller.shadow_traffic.remote(
            endpoint, backend, proportion), timeout=60)

    def list_endpoints(self) -> dict:
        return ray_tpu_torch.get(self._controller.list_endpoints.remote(),
                                 timeout=60)

    def get_handle(self, endpoint: str) -> ServeHandle:
        if endpoint not in self._handles:
            self._handles[endpoint] = ServeHandle(self._controller, endpoint)
        return self._handles[endpoint]

    # -- http ------------------------------------------------------------

    def enable_http(self, host: str = "127.0.0.1", port: int = 0,
                    http_workers: int | None = None) -> int:
        """Start the HTTP proxy actors after the fact; returns the port."""
        if not self._proxies:
            self._proxies, self._http_port = _start_proxies(
                self._controller, host, port, http_workers)
        return self._http_port

    @property
    def http_port(self) -> int | None:
        return self._http_port

    def shutdown(self):
        global _client
        for handle in self._handles.values():
            handle._router.close()
        self._handles.clear()
        try:
            # stop the autoscale tick and tear every replica and gang
            # down before the hard kill: the port's runtime does not
            # kill an actor's actors with it (no owner fate-sharing)
            ray_tpu_torch.get(self._controller.stop.remote(), timeout=60)
        except Exception:
            pass
        for actor in self._proxies + [self._controller]:
            try:
                ray_tpu_torch.kill(actor)
            except Exception:
                pass
        if _client is self:
            _client = None


def _start_proxies(controller, host: str, port: int,
                   http_workers: int | None) -> tuple[list, int]:
    """N HTTP proxy processes sharing one port via SO_REUSEPORT — the
    kernel load-balances accepts, so qps scales past a single event
    loop's per-request ceiling (one pure-python loop tops out around
    1k qps; the reference leans on uvicorn's C hot path + one proxy
    per node instead).

    Default is ONE proxy: each proxy runs its own Router with its own
    in-flight accounting, so N proxies overcommit a backend's
    max_concurrent_queries cap up to N-fold — scaling out is an explicit
    choice (http_workers=N), not a surprise."""
    import socket

    n = http_workers or 1
    if n > 1 and port == 0:
        # reserve a concrete port all workers can share: a bound (not
        # listening) SO_REUSEPORT socket holds the number while the
        # proxies bind, and never receives connections
        holder = socket.socket()
        holder.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        holder.bind((host, 0))
        port = holder.getsockname()[1]
    else:
        holder = None
    proxies = []
    try:
        proxy_cls = ray_tpu_torch.remote(HTTPProxy)
        for _ in range(n):
            # append as we go (not a comprehension): if the k-th remote()
            # raises, the k-1 already-spawned proxies must be killable
            proxies.append(proxy_cls.remote(controller, host, port,
                                            reuse_port=(n > 1)))
        actual = ray_tpu_torch.get([p.port.remote() for p in proxies],
                                   timeout=60)
    except Exception:
        # a proxy failed to bind (port in use) or never came up: kill the
        # ones already spawned so nothing is leaked — the caller never
        # learns their handles (orphaned HTTPProxy actors)
        for p in proxies:
            try:
                ray_tpu_torch.kill(p)
            except Exception:
                pass
        raise
    finally:
        if holder is not None:
            holder.close()
    return proxies, actual[0]


def start(*, http: bool = False, http_host: str = "127.0.0.1",
          http_port: int = 0, http_workers: int | None = None,
          detached: bool = False) -> Client:
    """Start (or connect to) a serve instance (reference: api.py:533)."""
    global _client
    if _client is not None:
        if http and not _client._proxies:
            _client.enable_http(http_host, http_port, http_workers)
        return _client
    controller_cls = ray_tpu_torch.remote(ServeController)
    controller = controller_cls.remote()
    proxies = []
    port = None
    if http:
        try:
            proxies, port = _start_proxies(controller, http_host,
                                           http_port, http_workers)
        except Exception:
            # _start_proxies already killed its proxies; without this
            # the controller would outlive the failed start() as an
            # orphan no caller holds a handle to
            try:
                ray_tpu_torch.kill(controller)
            except Exception:
                pass
            raise
    _client = Client(controller, proxies, port)
    return _client


def connect() -> Client:
    if _client is None:
        raise RuntimeError("serve has not been started in this process")
    return _client


def shutdown():
    if _client is not None:
        _client.shutdown()
