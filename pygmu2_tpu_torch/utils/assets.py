"""Asset management: cached downloads and Strudel sample libraries.

Counterpart of ``pygmu2_tpu.utils.assets``, a copy on the port's
``handle_error`` and logger, of the reference asset plumbing (reference:
src/pygmu2/asset_manager.py:130-660, audio_library.py:173-280):

- AssetManager.load_asset(spec) resolves a wildcard asset spec against a
  local cache, falling back to pluggable remote loaders (Google Drive
  folder listing, raw.githubusercontent trees).
- AudioLibrary loads Strudel-style strudel.json sample maps
  (https://strudel.cc/) and hands out WavReaderPE readers.

Network access is via stdlib urllib; in offline environments the cache
is the source of truth.
"""

from __future__ import annotations

import fnmatch
import json
import shutil
import ssl
import urllib.parse
import urllib.request
from abc import ABC, abstractmethod
from pathlib import Path

from pygmu2_tpu_torch.core.config import handle_error
from pygmu2_tpu_torch.core.logger import get_logger

_log = get_logger(__name__)


class AssetLoadFailed(RuntimeError):
    """A remote asset matched but could not be downloaded."""


class AssetNotFound(FileNotFoundError):
    """No cached or remote asset matched the specification."""


def _default_cache_base() -> Path:
    return Path.home() / ".cache" / "pygmu2_tpu"


def _ssl_context() -> ssl.SSLContext:
    try:
        return ssl.create_default_context()
    except Exception:  # pragma: no cover
        return ssl._create_unverified_context()


def _http_get(url: str, timeout: float = 30.0) -> bytes:
    req = urllib.request.Request(url, headers={"User-Agent": "pygmu2-tpu"})
    with urllib.request.urlopen(req, timeout=timeout, context=_ssl_context()) as r:
        return r.read()


class AssetLoader(ABC):
    """Backend that can list and fetch remote assets."""

    @abstractmethod
    def list_remote_assets(self, wildcard_spec: str) -> list[str]:
        """Names of remote assets matching the wildcard spec."""

    @abstractmethod
    def load_remote_asset(self, wildcard_spec: str, cache_dir: Path) -> Path | None:
        """Download the first matching asset into cache_dir; None if none."""


class GithubUserContentAssetLoader(AssetLoader):
    """Fetches files from raw.githubusercontent.com.

    Args: user, repo, branch, root (path prefix inside the repo).
    Listing uses the GitHub contents API.
    """

    def __init__(self, user: str, repo: str, branch: str = "main", root: str = ""):
        self._user = user
        self._repo = repo
        self._branch = branch
        self._root = root.strip("/")

    def _api_list(self, subdir: str) -> list[dict]:
        path = "/".join(p for p in (self._root, subdir) if p)
        url = (
            f"https://api.github.com/repos/{self._user}/{self._repo}/"
            f"contents/{path}?ref={self._branch}"
        )
        return json.loads(_http_get(url))

    def list_remote_assets(self, wildcard_spec: str) -> list[str]:
        subdir, pattern = self._split(wildcard_spec)
        try:
            items = self._api_list(subdir)
        except Exception as exc:
            _log.warning("github listing failed: %s", exc)
            return []
        names = [i["name"] for i in items if i.get("type") == "file"]
        return [
            ("/".join(p for p in (subdir, n) if p))
            for n in names
            if fnmatch.fnmatch(n, pattern)
        ]

    def load_remote_asset(self, wildcard_spec: str, cache_dir: Path) -> Path | None:
        matches = self.list_remote_assets(wildcard_spec)
        if not matches:
            return None
        rel = matches[0]
        path = "/".join(p for p in (self._root, rel) if p)
        url = (
            f"https://raw.githubusercontent.com/{self._user}/{self._repo}/"
            f"{self._branch}/{path}"
        )
        dest = cache_dir / Path(rel).name
        try:
            dest.write_bytes(_http_get(url))
        except Exception as exc:
            raise AssetLoadFailed(f"download failed for {url}: {exc}") from exc
        return dest

    @staticmethod
    def _split(spec: str) -> tuple[str, str]:
        parts = spec.rsplit("/", 1)
        return ("", parts[0]) if len(parts) == 1 else (parts[0], parts[1])


class GoogleDriveAssetLoader(AssetLoader):
    """Fetches files from a shared Google Drive folder (API-key listing)."""

    _API = "https://www.googleapis.com/drive/v3/files"

    def __init__(self, folder_id: str, api_key: str):
        self._folder_id = folder_id
        self._api_key = api_key

    def _list_folder(self, folder_id: str) -> list[dict]:
        params = urllib.parse.urlencode(
            {
                "q": f"'{folder_id}' in parents and trashed = false",
                "key": self._api_key,
                "fields": "files(id,name,mimeType)",
                "pageSize": 1000,
            }
        )
        return json.loads(_http_get(f"{self._API}?{params}")).get("files", [])

    def list_remote_assets(self, wildcard_spec: str) -> list[str]:
        return [name for name, _ in self._matches(wildcard_spec)]

    def _matches(self, wildcard_spec: str) -> list[tuple[str, str]]:
        try:
            items = self._list_folder(self._folder_id)
        except Exception as exc:
            _log.warning("drive listing failed: %s", exc)
            return []
        return [
            (i["name"], i["id"])
            for i in items
            if fnmatch.fnmatch(i["name"], wildcard_spec)
        ]

    def load_remote_asset(self, wildcard_spec: str, cache_dir: Path) -> Path | None:
        matches = self._matches(wildcard_spec)
        if not matches:
            return None
        name, file_id = matches[0]
        url = f"{self._API}/{file_id}?alt=media&key={self._api_key}"
        dest = cache_dir / name
        try:
            dest.write_bytes(_http_get(url))
        except Exception as exc:
            raise AssetLoadFailed(f"download failed for {name}: {exc}") from exc
        return dest


class AssetManager:
    """Wildcard asset resolution over a local cache + remote loaders."""

    def __init__(self, loaders: list[AssetLoader] | None = None, cache_dir: Path | None = None):
        self._loaders = list(loaders or [])
        self._cache_dir = Path(cache_dir) if cache_dir else self._default_cache_dir()
        self._cache_dir.mkdir(parents=True, exist_ok=True)

    @staticmethod
    def _default_cache_dir() -> Path:
        return _default_cache_base() / "assets"

    @property
    def cache_path(self) -> Path:
        return self._cache_dir

    def locate_local_asset(self, asset_specification: str) -> Path | None:
        return next(
            (p for p in sorted(self._cache_dir.glob(asset_specification)) if p.exists()),
            None,
        )

    def list_cached_assets(self, asset_specification: str) -> list[Path]:
        return [p for p in sorted(self._cache_dir.glob(asset_specification)) if p.exists()]

    def has_cached_asset(self, asset_specification: str) -> bool:
        return self.locate_local_asset(asset_specification) is not None

    def list_remote_assets(self, asset_specification: str) -> list[str]:
        names: list[str] = []
        for loader in self._loaders:
            names.extend(loader.list_remote_assets(asset_specification))
        return names

    def load_asset(self, asset_specification: str, force: bool = False) -> Path:
        """Resolve an asset: cache hit, else first loader that has it."""
        if not force:
            local = self.locate_local_asset(asset_specification)
            if local is not None:
                return local
        for loader in self._loaders:
            path = loader.load_remote_asset(asset_specification, self._cache_dir)
            if path is not None:
                return path
        raise AssetNotFound(
            f"No asset matching {asset_specification!r} in cache "
            f"({self._cache_dir}) or remotes."
        )

    def clear_cache(self) -> None:
        if self._cache_dir.exists():
            shutil.rmtree(self._cache_dir)
        self._cache_dir.mkdir(parents=True, exist_ok=True)


class AudioLibrary:
    """Strudel-style sample map: name → list of audio files."""

    def __init__(self, mapping: dict[str, list[str]], base: Path | None = None):
        self._mapping = mapping
        self._base = base

    @classmethod
    def from_strudel_json(cls, path) -> "AudioLibrary":
        json_path = Path(path).expanduser()
        with json_path.open("r", encoding="utf-8") as f:
            data = json.load(f)
        return cls._from_strudel_data(data, source_dir=json_path.parent)

    @classmethod
    def from_url(cls, url: str, cache_root: Path | None = None) -> "AudioLibrary":
        cache_root = Path(cache_root) if cache_root else _default_cache_base() / "libraries"
        cache_root.mkdir(parents=True, exist_ok=True)
        cached = cache_root / (
            urllib.parse.quote_plus(url.rstrip("/")) + ".json"
        )
        if not cached.exists():
            cached.write_bytes(_http_get(url))
        with cached.open("r", encoding="utf-8") as f:
            data = json.load(f)
        base_url = data.get("_base", url.rsplit("/", 1)[0] + "/")
        lib = cls._from_strudel_data(data, source_dir=None, base_url=base_url)
        lib._cache_root = cache_root
        return lib

    @classmethod
    def _from_strudel_data(cls, data, source_dir=None, base_url=None) -> "AudioLibrary":
        if not isinstance(data, dict):
            handle_error("strudel.json must contain a top-level object.", fatal=True)
        mapping: dict[str, list[str]] = {}
        for name, value in data.items():
            if name.startswith("_"):
                continue
            if isinstance(value, str):
                mapping[name] = [value]
            elif isinstance(value, list):
                mapping[name] = [str(v) for v in value]
        lib = cls(mapping, base=source_dir)
        lib._base_url = base_url
        return lib

    @property
    def keys(self) -> list[str]:
        return sorted(self._mapping)

    def resolve(self, name: str, index: int = 0) -> str:
        if name not in self._mapping:
            raise KeyError(f"unknown sample name: {name!r}")
        paths = self._mapping[name]
        rel = paths[index % len(paths)]
        if self._base is not None:
            return str(Path(self._base) / rel)
        base_url = getattr(self, "_base_url", None)
        if base_url:
            cache_root = getattr(self, "_cache_root", _default_cache_base() / "libraries")
            dest = Path(cache_root) / Path(rel).name
            if not dest.exists():
                dest.write_bytes(_http_get(urllib.parse.urljoin(base_url, rel)))
            return str(dest)
        return rel

    def reader(self, name: str, index: int = 0):
        """A WavReaderPE for the named sample."""
        from pygmu2_tpu_torch.models.io_pes import WavReaderPE

        return WavReaderPE(self.resolve(name, index))

    def print_keys(self, columns: int = 3, width: int = 25) -> None:
        keys = self.keys
        for row_start in range(0, len(keys), columns):
            row = keys[row_start : row_start + columns]
            print("".join(k.ljust(width) for k in row))

    def __repr__(self) -> str:
        return f"AudioLibrary(n_sounds={len(self._mapping)})"
