"""FlexArena and PagedArena, host side (the port's copy of
``repro.core.arena``).

FILCO's Flexible Memory Unit as a software-managed buffer pool: a 1-D
arena whose regions are reinterpreted as 2-D views of any shape and role,
so storage is size-limited, never shape-limited.  The serving engine uses
it for KV admission accounting: the slot-granular ``FlexArena`` or the
fixed-page ``PagedArena`` over it.  The arenas are pure Python; the
device-side view ops at the end (``store_view``, ``load_view``,
``load_padded``) read and write a view's window of a flat torch buffer.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

ROLE_WEIGHT = "weight"
ROLE_ACT = "activation"
ROLE_RESULT = "result"
ROLES = (ROLE_WEIGHT, ROLE_ACT, ROLE_RESULT)


@dataclasses.dataclass(frozen=True)
class View:
    """A runtime 2-D window into a flat arena."""

    offset: int          # element offset into the arena
    rows: int
    cols: int
    role: str
    view_id: int

    @property
    def size(self) -> int:
        return self.rows * self.cols


class AllocationError(RuntimeError):
    pass


class FlexArena:
    """First-fit 1-D allocator with runtime-shaped views.

    capacity: elements.  align: element alignment for view starts.
    """

    def __init__(self, capacity: int, *, align: int = 1):
        self.capacity = int(capacity)
        self.align = int(align)
        self._views: Dict[int, View] = {}
        self._next_id = 0

    # -- bookkeeping -----------------------------------------------------
    def _gaps(self) -> List[Tuple[int, int]]:
        """Free (start, length) gaps, sorted by start."""
        used = sorted((v.offset, v.offset + v.size) for v in self._views.values())
        gaps, cur = [], 0
        for s, e in used:
            if s > cur:
                gaps.append((cur, s - cur))
            cur = max(cur, e)
        if cur < self.capacity:
            gaps.append((cur, self.capacity - cur))
        return gaps

    @property
    def used(self) -> int:
        return sum(v.size for v in self._views.values())

    @property
    def free(self) -> int:
        return self.capacity - self.used

    def utilization(self) -> float:
        return self.used / self.capacity if self.capacity else 0.0

    def views(self) -> List[View]:
        return sorted(self._views.values(), key=lambda v: v.offset)

    # -- allocation ------------------------------------------------------
    def _align_up(self, x: int) -> int:
        a = self.align
        return -(-x // a) * a

    def alloc(self, rows: int, cols: int, role: str = ROLE_ACT) -> View:
        """Allocate a (rows, cols) view; shape is metadata, storage is
        rows*cols elements, no padding."""
        if role not in ROLES:
            raise ValueError(f"unknown role {role!r}")
        need = rows * cols
        for start, length in self._gaps():
            astart = self._align_up(start)
            if astart + need <= start + length:
                v = View(astart, rows, cols, role, self._next_id)
                self._views[self._next_id] = v
                self._next_id += 1
                return v
        raise AllocationError(
            f"arena full: need {need}, free {self.free} (fragmented)")

    def free_view(self, view: View) -> None:
        self._views.pop(view.view_id, None)

    def reshape_view(self, view: View, rows: int, cols: int,
                     role: Optional[str] = None) -> View:
        """Reinterpret an existing allocation under a new 2-D shape/role;
        the new shape must not exceed the original allocation."""
        if rows * cols > view.size:
            raise AllocationError(
                f"view reshape {rows}x{cols} exceeds allocation {view.size}")
        nv = View(view.offset, rows, cols, role or view.role, view.view_id)
        self._views[view.view_id] = nv
        return nv

    def fits(self, shapes: List[Tuple[int, int]]) -> bool:
        """Would these operands fit together?  Storage is 1-D: total
        elements vs free capacity."""
        return sum(r * c for r, c in shapes) <= self.free


# ---------------------------------------------------------------------------
# paged arena: fixed-size pages over the FlexArena substrate
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PageTable:
    """The ordered fixed-size pages backing one slot's cache.  ``rows`` is
    the logical row count asked for so far; the reserved storage is
    ``len(pages) * page_rows`` rows."""

    table_id: int
    rows: int
    cols: int
    role: str
    pages: List[View]

    @property
    def size(self) -> int:
        """Reserved elements (whole pages, not the logical ``rows``)."""
        return sum(p.size for p in self.pages)


class PagedArena:
    """Fixed-size-page allocator over a :class:`FlexArena` substrate.

    Every page is a ``(page_rows, cols)`` view, so allocation never
    fragments.  Owners hold :class:`PageTable` s and ``grow`` them one page
    at a time; ``free_view`` returns every page.  The interface mirrors
    ``FlexArena`` so the engine can use either as its admission arena.
    """

    def __init__(self, num_pages: int, page_rows: int, cols: int, *,
                 align: int = 1):
        if num_pages < 1 or page_rows < 1 or cols < 1:
            raise ValueError(
                f"PagedArena needs positive geometry, got "
                f"num_pages={num_pages} page_rows={page_rows} cols={cols}")
        self.num_pages = int(num_pages)
        self.page_rows = int(page_rows)
        self.cols = int(cols)
        self.page_elems = self.page_rows * self.cols
        self._substrate = FlexArena(self.num_pages * self.page_elems,
                                    align=align)
        self._tables: Dict[int, PageTable] = {}
        self._next_id = 0

    # -- accounting ------------------------------------------------------
    def pages_for(self, rows: int) -> int:
        """Pages needed to cover ``rows`` logical rows."""
        return -(-max(int(rows), 0) // self.page_rows)

    @property
    def used_pages(self) -> int:
        return sum(len(t.pages) for t in self._tables.values())

    @property
    def free_pages(self) -> int:
        return self.num_pages - self.used_pages

    @property
    def capacity(self) -> int:
        return self.num_pages * self.page_elems

    @property
    def used(self) -> int:
        return self.used_pages * self.page_elems

    @property
    def free(self) -> int:
        return self.capacity - self.used

    def utilization(self) -> float:
        return self.used_pages / self.num_pages if self.num_pages else 0.0

    def tables(self) -> List[PageTable]:
        return sorted(self._tables.values(), key=lambda t: t.table_id)

    def fits(self, shapes: List[Tuple[int, int]]) -> bool:
        return sum(self.pages_for(r) for r, _ in shapes) <= self.free_pages

    # -- allocation ------------------------------------------------------
    def _carve(self, n: int, role: str) -> List[View]:
        if n > self.free_pages:
            raise AllocationError(
                f"paged arena full: need {n} pages, free {self.free_pages} "
                f"of {self.num_pages}")
        return [self._substrate.alloc(self.page_rows, self.cols, role)
                for _ in range(n)]

    def alloc(self, rows: int, cols: int, role: str = ROLE_ACT) -> PageTable:
        """Open a page table covering ``rows`` rows; ``cols`` must match
        the arena's column width."""
        if role not in ROLES:
            raise ValueError(f"unknown role {role!r}")
        if cols != self.cols:
            raise AllocationError(
                f"paged arena is {self.cols} cols wide, got {cols}")
        if rows < 1:
            raise AllocationError(f"page table needs rows >= 1, got {rows}")
        pages = self._carve(self.pages_for(rows), role)
        t = PageTable(self._next_id, int(rows), self.cols, role, pages)
        self._tables[self._next_id] = t
        self._next_id += 1
        return t

    def grow(self, table: PageTable, rows: int) -> PageTable:
        """Extend ``table`` to cover ``rows`` rows, allocating pages only
        across a page boundary.  Raises :class:`AllocationError` (table
        unchanged) when no page is free: the preemption trigger."""
        if table.table_id not in self._tables:
            raise AllocationError(f"grow on a freed table {table.table_id}")
        need = self.pages_for(rows) - len(table.pages)
        if need > 0:
            table.pages.extend(self._carve(need, table.role))
        if rows > table.rows:
            table.rows = int(rows)
        return table

    def free_view(self, table: PageTable) -> None:
        """Release every page back to the substrate (idempotent)."""
        t = self._tables.pop(table.table_id, None)
        if t is None:
            return
        for p in t.pages:
            self._substrate.free_view(p)
        t.pages.clear()

    def check(self) -> None:
        """Assert structural invariants: pages never overlap, page counts
        and substrate accounting agree, free count within range."""
        spans = sorted((p.offset, p.offset + p.size)
                       for t in self._tables.values() for p in t.pages)
        for (_, e0), (s1, _) in zip(spans, spans[1:]):
            if s1 < e0:
                raise AssertionError(f"overlapping pages at {s1} < {e0}")
        n_pages = sum(len(t.pages) for t in self._tables.values())
        if n_pages * self.page_elems != self._substrate.used:
            raise AssertionError(
                f"leak: {n_pages} pages vs substrate used "
                f"{self._substrate.used}")
        if not 0 <= self.free_pages <= self.num_pages:
            raise AssertionError(f"free_pages out of range: {self.free_pages}")
        for t in self._tables.values():
            if len(t.pages) != self.pages_for(max(t.rows, 1)):
                raise AssertionError(
                    f"table {t.table_id}: rows {t.rows} vs "
                    f"{len(t.pages)} pages")


# ---------------------------------------------------------------------------
# device-side view ops on a flat buffer
# ---------------------------------------------------------------------------

def store_view(arena_buf: torch.Tensor, view: View,
               matrix: torch.Tensor) -> torch.Tensor:
    """Write a (rows, cols) matrix into the flat arena at the view window,
    in place (cast to the buffer's dtype); returns the buffer."""
    arena_buf.narrow(0, view.offset, view.size).copy_(matrix.reshape(-1))
    return arena_buf


def load_view(arena_buf: torch.Tensor, view: View) -> torch.Tensor:
    """The view window as a (rows, cols) matrix (a view of the buffer)."""
    return arena_buf.narrow(0, view.offset, view.size).view(view.rows,
                                                            view.cols)


def load_padded(arena_buf: torch.Tensor, view: View,
                padded_shape: Tuple[int, int]) -> torch.Tensor:
    """A view read into a zero-padded (max-shape) matrix: the handoff
    format of the ``filco_mm`` kernel (padded operands + runtime valid
    dims)."""
    pr, pc = padded_shape
    return torch.nn.functional.pad(load_view(arena_buf, view),
                                   (0, pc - view.cols, 0, pr - view.rows))
