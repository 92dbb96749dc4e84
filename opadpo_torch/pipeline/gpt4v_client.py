"""Azure / OpenAI chat client with a sqlite response cache and retry:
copy of ``opadpo_tpu/pipeline/gpt4v_client.py``.

Port of the reference's API plumbing (``opadpo/generator_models/prompt/
call_openai_API.py``): md5-keyed sqlite cache (``history.sqlite``), retry
with 6 s backoff up to 30 attempts, lock-serialised writes, and per-rank
key selection ``RANK % API_NUM`` with ``API_KEY{i}`` / ``AZURE_POINT{i}``
environment variables (``generator.py:87-93``).  The transport is plain
``requests``, imported inside the call.
"""

from __future__ import annotations

import hashlib
import json
import os
import sqlite3
import threading
import time
from typing import Dict, List, Optional


class SqliteStore:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.conn = sqlite3.connect(path, check_same_thread=False)
        self.lock = threading.Lock()
        with self.lock:
            self.conn.execute(
                "CREATE TABLE IF NOT EXISTS cache "
                "(key TEXT PRIMARY KEY, value TEXT)")
            self.conn.commit()

    def get(self, key: str) -> Optional[str]:
        with self.lock:
            row = self.conn.execute(
                "SELECT value FROM cache WHERE key=?", (key,)).fetchone()
        return row[0] if row else None

    def put(self, key: str, value: str) -> None:
        with self.lock:
            self.conn.execute(
                "INSERT OR REPLACE INTO cache (key, value) VALUES (?, ?)",
                (key, value))
            self.conn.commit()


def get_cache_key(model: str, messages: List[Dict], **params) -> str:
    payload = json.dumps({"model": model, "messages": messages,
                          "params": params}, sort_keys=True)
    return hashlib.md5(payload.encode()).hexdigest()


class APIService:
    def __init__(self, api_key: str, endpoint: str,
                 model: str = "gpt-4-vision-preview",
                 api_version: str = "2024-02-15-preview",
                 cache_path: str = "history.sqlite",
                 max_retries: int = 30, retry_sleep: float = 6.0,
                 is_azure: Optional[bool] = None):
        self.api_key = api_key
        self.endpoint = endpoint.rstrip("/")
        self.model = model
        self.api_version = api_version
        self.cache = SqliteStore(cache_path)
        self.max_retries = max_retries
        self.retry_sleep = retry_sleep
        self.is_azure = (is_azure if is_azure is not None
                         else "azure" in self.endpoint)

    def _url(self) -> str:
        if self.is_azure:
            return (f"{self.endpoint}/openai/deployments/{self.model}"
                    f"/chat/completions?api-version={self.api_version}")
        return f"{self.endpoint}/v1/chat/completions"

    def _headers(self) -> Dict[str, str]:
        if self.is_azure:
            return {"api-key": self.api_key,
                    "Content-Type": "application/json"}
        return {"Authorization": f"Bearer {self.api_key}",
                "Content-Type": "application/json"}

    def call_llm_with_messages(self, messages: List[Dict],
                               temperature: float = 0.0,
                               max_tokens: int = 2048,
                               use_cache: bool = True) -> str:
        import requests

        key = get_cache_key(self.model, messages, temperature=temperature,
                            max_tokens=max_tokens)
        if use_cache:
            cached = self.cache.get(key)
            if cached is not None:
                return cached

        body = {"messages": messages, "temperature": temperature,
                "max_tokens": max_tokens}
        if not self.is_azure:
            body["model"] = self.model

        last_err: Optional[Exception] = None
        for _ in range(self.max_retries):
            try:
                resp = requests.post(self._url(), headers=self._headers(),
                                     json=body, timeout=120)
                if resp.status_code == 200:
                    text = resp.json()["choices"][0]["message"]["content"]
                    self.cache.put(key, text)
                    return text
                last_err = RuntimeError(
                    f"HTTP {resp.status_code}: {resp.text[:200]}")
            except Exception as e:      # network failure → retry
                last_err = e
            time.sleep(self.retry_sleep)
        raise RuntimeError(f"GPT-4V call failed after "
                           f"{self.max_retries} retries: {last_err}")


def get_api_service(rank: int = 0,
                    cache_path: str = "history.sqlite") -> APIService:
    """Per-rank key selection: RANK % API_NUM (reference generator.py:87-93)."""
    api_num = int(os.environ.get("API_NUM", "1"))
    idx = rank % api_num
    api_key = os.environ.get(f"API_KEY{idx}", os.environ.get("API_KEY", ""))
    endpoint = os.environ.get(f"AZURE_POINT{idx}",
                              os.environ.get("AZURE_POINT",
                                             "https://api.openai.com"))
    model = os.environ.get("API_MODEL", "gpt-4-vision-preview")
    return APIService(api_key=api_key, endpoint=endpoint, model=model,
                      cache_path=cache_path)
