"""Abstract engine interface."""
from __future__ import annotations

from abc import ABC, abstractmethod


class BaseEngine(ABC):
    @abstractmethod
    def initialize(self): ...

    @abstractmethod
    def prefill(self, text: str): ...

    @abstractmethod
    def append(self, text: str): ...

    @abstractmethod
    def _prefill(self, input_ids): ...

    @abstractmethod
    def _append(self, input_ids): ...

    @abstractmethod
    def build_tree(self): ...

    @abstractmethod
    def verify(self): ...

    @abstractmethod
    def speculative_decoding(self, max_new_tokens: int): ...

    @abstractmethod
    def validate_status(self): ...

    @abstractmethod
    def update_generation_args(self, **generation_args): ...

    @abstractmethod
    def reset(self): ...

    @abstractmethod
    def generate(self, **api_args): ...
