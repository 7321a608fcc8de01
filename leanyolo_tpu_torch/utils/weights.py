"""Weight resolution: local path -> env dir -> cache -> download (+SHA-256).

Counterpart of the JAX package's `leanyolo_tpu/utils/weights.py`, a copy
kept so the port never imports the JAX package: the same resolution order,
cache environment variables (LEANYOLO_WEIGHTS_DIR, LEANYOLO_CACHE_DIR),
streaming download with atomic replace, and hash verification with
delete-on-mismatch. A file found in LEANYOLO_WEIGHTS_DIR is taken as it is,
without a hash check. The checkpoint reader (safe unpickling with dynamic
stubs) lives in torch_reader.py.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from dataclasses import dataclass
from typing import Any, Dict, Optional
from urllib.parse import urlparse
from urllib.request import urlopen


@dataclass
class WeightsEntry:
    name: str
    url: Optional[str]
    filename: Optional[str] = None
    metadata: Optional[Dict[str, Any]] = None
    sha256: Optional[str] = None  # lowercase hex digest

    def _default_cache_dir(self) -> str:
        return os.environ.get(
            "LEANYOLO_CACHE_DIR",
            os.path.join(os.path.expanduser("~"), ".cache", "leanyolo_tpu"),
        )

    def _target_filename(self) -> str:
        if self.filename:
            return self.filename
        if self.url:
            return os.path.basename(urlparse(self.url).path) or f"{self.name}.pt"
        return f"{self.name}.pt"

    @staticmethod
    def _sha256_of_file(path: str, chunk_size: int = 1 << 20) -> str:
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(chunk_size), b""):
                h.update(chunk)
        return h.hexdigest()

    @staticmethod
    def _download_to(url: str, dst: str) -> None:
        """Streaming download to a temp file, then atomic replace."""
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        with tempfile.NamedTemporaryFile(delete=False, dir=os.path.dirname(dst)) as tmp:
            tmp_path = tmp.name
            try:
                with urlopen(url) as r:  # nosec - URL comes from the registry/tests
                    while True:
                        chunk = r.read(1 << 20)
                        if not chunk:
                            break
                        tmp.write(chunk)
            except BaseException:
                tmp.close()
                os.remove(tmp_path)
                raise
        os.replace(tmp_path, dst)

    def resolve_path(
        self,
        *,
        local_path: Optional[str] = None,
        cache_dir: Optional[str] = None,
    ) -> str:
        """Return a verified local file path for this entry, downloading if needed."""
        if local_path is not None:
            return local_path

        filename = self._target_filename()
        env_dir = os.environ.get("LEANYOLO_WEIGHTS_DIR")
        if env_dir:
            candidate = os.path.join(env_dir, filename)
            if os.path.exists(candidate):
                return candidate

        cache_dir = cache_dir or self._default_cache_dir()
        os.makedirs(cache_dir, exist_ok=True)
        cache_path = os.path.join(cache_dir, filename)

        def valid_hash(path: str) -> bool:
            if not self.sha256:
                return True
            try:
                return self._sha256_of_file(path) == self.sha256
            except FileNotFoundError:
                return False

        if os.path.exists(cache_path) and valid_hash(cache_path):
            return cache_path

        if not self.url:
            raise FileNotFoundError(
                f"Weights not found locally ('{cache_path}') and no URL to download "
                "from. Place the file in LEANYOLO_WEIGHTS_DIR or pass local_path."
            )
        self._download_to(self.url, cache_path)
        if not valid_hash(cache_path):
            os.remove(cache_path)
            raise RuntimeError(f"Downloaded file hash mismatch for weights '{filename}'.")
        return cache_path

    def get_state_dict(
        self,
        *,
        local_path: Optional[str] = None,
        cache_dir: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Resolve and load a torch checkpoint into a flat state dict of CPU tensors."""
        from .torch_reader import load_torch_checkpoint

        path = self.resolve_path(local_path=local_path, cache_dir=cache_dir)
        return load_torch_checkpoint(path)

