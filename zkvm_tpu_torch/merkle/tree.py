"""Generic sparse Merkle tree (coset-merkle/src/{tree,node,opening,walk}.rs).

Hash-agnostic: item types implement the Aggregate protocol (EMPTY_SUBTREE +
aggregate).  The tree is lazily allocated; aggregated items are cached per
node and invalidated along the insertion path, exactly like the reference's
RefCell scheme.
"""

from __future__ import annotations

from typing import Callable, Generic, Iterator, TypeVar

T = TypeVar("T")


class Aggregate:
    """Protocol: subclasses define EMPTY_SUBTREE (classlevel) and
    aggregate(items) (coset-merkle/src/lib.rs:22-27)."""

    EMPTY_SUBTREE = None

    @classmethod
    def aggregate(cls, items):
        raise NotImplementedError


class UnitAggregate(Aggregate):
    """Aggregate for data-less items (impl for `()`)."""

    EMPTY_SUBTREE = None

    @classmethod
    def aggregate(cls, items):
        return None


class _Node(Generic[T]):
    __slots__ = ("item", "children")

    def __init__(self, arity: int):
        self.item = None  # cached aggregate
        self.children: list[_Node | None] = [None] * arity


class Tree(Generic[T]):
    """Arity-A height-H tree (tree.rs:14-147).

    `item_type` supplies EMPTY_SUBTREE / aggregate.
    """

    def __init__(self, item_type, height: int, arity: int):
        assert height > 0 and arity > 0
        self.item_type = item_type
        self.height = height
        self.arity = arity
        self.root_node: _Node = _Node(arity)
        self.positions: set[int] = set()

    # -- helpers -----------------------------------------------------------------
    def capacity(self) -> int:
        return self.arity ** self.height

    def __len__(self) -> int:
        return len(self.positions)

    def is_empty(self) -> bool:
        return not self.positions

    def contains(self, position: int) -> bool:
        return position in self.positions

    def _child_index_and_offset(self, height: int, position: int):
        child_cap = self.arity ** (self.height - height - 1)
        return position // child_cap, position % child_cap

    def _aggregated_item(self, node: _Node):
        if node.item is None:
            empty = self.item_type.EMPTY_SUBTREE
            refs = []
            has_children = False
            for child in node.children:
                if child is None:
                    refs.append(empty)
                else:
                    refs.append(self._aggregated_item(child))
                    has_children = True
            node.item = (self.item_type.aggregate(refs) if has_children
                         else empty)
        return node.item

    # -- public API (tree.rs) -------------------------------------------------------
    def insert(self, index: int, item) -> None:
        if index >= self.capacity():
            raise IndexError(
                f"index out of bounds: the capacity is {self.capacity()} "
                f"but the index is {index}")
        self._insert(self.root_node, 0, index, item)
        self.positions.add(index)

    def _insert(self, node: _Node, height: int, position: int, item) -> None:
        if height == self.height:
            node.item = item
            return
        node.item = None
        child_index, child_pos = self._child_index_and_offset(height, position)
        if node.children[child_index] is None:
            node.children[child_index] = _Node(self.arity)
        self._insert(node.children[child_index], height + 1, child_pos, item)

    def remove(self, position: int):
        if position not in self.positions:
            return None
        item, _ = self._remove(self.root_node, 0, position)
        self.positions.discard(position)
        return item

    def _remove(self, node: _Node, height: int, position: int):
        if height == self.height:
            item = node.item
            node.item = None
            return item, False
        node.item = None
        child_index, child_pos = self._child_index_and_offset(height, position)
        child = node.children[child_index]
        item, child_has_children = self._remove(child, height + 1, child_pos)
        if not child_has_children:
            node.children[child_index] = None
        return item, any(c is not None for c in node.children)

    def root(self):
        return self._aggregated_item(self.root_node)

    def smallest_subtree(self):
        """(aggregate, height) of the smallest subtree holding all leaves
        (tree.rs:94-131)."""
        node = self.root_node
        height = self.height
        while True:
            non_empty = [c for c in node.children if c is not None]
            if not non_empty:
                return self.root(), 0
            if len(non_empty) == 1 and height > 1:
                node = non_empty[0]
            else:
                return self._aggregated_item(node), height
            height -= 1

    # -- whole-tree archive (node.rs:158-214 ArchivedNode capability) ---------
    _ARCHIVE_MAGIC = b"ZKTREE01"

    def to_archive_bytes(self, item_to_bytes=None) -> bytes:
        """Serialize the WHOLE tree (structure + cached aggregates +
        occupied positions) to one self-describing blob -- the capability
        of the reference's recursive rkyv archive for Node
        (coset-merkle/src/node.rs:158-214).  Nodes are depth-first with a
        1-byte Option tag per item/child slot, mirroring the archived
        `item: Option<T>` + `children: [Option<Box<Node>>; A]` shape."""
        to_bytes = item_to_bytes or (lambda it: it.to_bytes())
        out = bytearray(self._ARCHIVE_MAGIC)
        out += self.height.to_bytes(4, "little")
        out += self.arity.to_bytes(4, "little")
        out += len(self.positions).to_bytes(8, "little")
        for p in sorted(self.positions):
            out += int(p).to_bytes(8, "little")

        def emit(node: _Node | None):
            if node is None:
                out.append(0)
                return
            out.append(1)
            if node.item is None:
                out.append(0)
            else:
                out.append(1)
                item = to_bytes(node.item)
                out.extend(len(item).to_bytes(4, "little"))
                out.extend(item)
            for child in node.children:
                emit(child)

        emit(self.root_node)
        return bytes(out)

    @classmethod
    def from_archive_bytes(cls, buf: bytes, item_type, item_from_bytes,
                           tree=None) -> "Tree":
        """Rebuild a tree from `to_archive_bytes` output.  `tree` lets
        subclasses pass a pre-constructed instance to fill."""
        magic = cls._ARCHIVE_MAGIC
        if buf[: len(magic)] != magic:
            raise ValueError("bad tree archive magic")
        pos = len(magic)
        height = int.from_bytes(buf[pos: pos + 4], "little")
        arity = int.from_bytes(buf[pos + 4: pos + 8], "little")
        n_pos = int.from_bytes(buf[pos + 8: pos + 16], "little")
        pos += 16
        positions = set()
        for _ in range(n_pos):
            positions.add(int.from_bytes(buf[pos: pos + 8], "little"))
            pos += 8
        if tree is None:
            tree = cls(item_type, height, arity)
        elif tree.height != height or tree.arity != arity:
            raise ValueError("tree shape mismatch")

        def read_node():
            nonlocal pos
            tag = buf[pos]
            pos += 1
            if tag == 0:
                return None
            node = _Node(arity)
            has_item = buf[pos]
            pos += 1
            if has_item:
                ln = int.from_bytes(buf[pos: pos + 4], "little")
                pos += 4
                node.item = item_from_bytes(buf[pos: pos + ln])
                pos += ln
            node.children = [read_node() for _ in range(arity)]
            return node

        root = read_node()
        if pos != len(buf):
            raise ValueError("trailing bytes in tree archive")
        tree.root_node = root if root is not None else _Node(arity)
        tree.positions = positions
        return tree

    def opening(self, position: int):
        if position not in self.positions:
            return None
        return Opening(self, position)

    def walk(self, walker: Callable) -> Iterator:
        """Depth-first iterator over leaves of subtrees accepted by `walker`
        (walk.rs:8-146)."""
        yield from self._walk(self.root_node, 0, walker)

    def _walk(self, node: _Node, height: int, walker: Callable):
        for child in node.children:
            if child is None:
                continue
            item = self._aggregated_item(child)
            if height + 1 == self.height:
                if walker(item):
                    yield item
            elif walker(item):
                yield from self._walk(child, height + 1, walker)


class Opening(Generic[T]):
    """Merkle opening: branch + positions per level (opening.rs:19-135)."""

    def __init__(self, tree: Tree | None, position: int | None = None, *,
                 root=None, branch=None, positions=None,
                 item_type=None, height=None, arity=None):
        if tree is not None:
            self.item_type = tree.item_type
            self.height = tree.height
            self.arity = tree.arity
            self.root = tree.root()
            empty = self.item_type.EMPTY_SUBTREE
            self.branch = [[empty] * self.arity for _ in range(self.height)]
            self.positions = [0] * self.height
            self._populate(tree, tree.root_node, 0, position)
        else:
            self.item_type = item_type
            self.height = height
            self.arity = arity
            self.root = root
            self.branch = branch
            self.positions = positions

    def _populate(self, tree: Tree, node: _Node, height: int, position: int):
        if height == self.height:
            return
        child_index, child_pos = tree._child_index_and_offset(height, position)
        child = node.children[child_index]
        self._populate(tree, child, height + 1, child_pos)
        for i, c in enumerate(node.children):
            if c is not None:
                self.branch[height][i] = tree._aggregated_item(c)
        self.positions[height] = child_index

    def verify(self, item) -> bool:
        """Recompute the root bottom-up (opening.rs:68-102)."""
        for level_index in range(self.height - 1, -1, -1):
            level_branch = self.branch[level_index]
            level_position = self.positions[level_index]
            if item != level_branch[level_position]:
                return False
            item = self.item_type.aggregate(list(level_branch))
        return self.root == item

    # -- wire format (opening.rs:104-135): root + branch items + u32 positions ----
    def to_var_bytes(self, item_to_bytes=None) -> bytes:
        to_bytes = item_to_bytes or (lambda it: it.to_bytes())
        out = bytearray(to_bytes(self.root))
        for level in self.branch:
            for item in level:
                out += to_bytes(item)
        for p in self.positions:
            out += int(p).to_bytes(4, "little")
        return bytes(out)

    @classmethod
    def from_slice(cls, buf: bytes, item_type, height: int, arity: int,
                   item_size: int, item_from_bytes) -> "Opening":
        expected = (1 + height * arity) * item_size + height * 4
        if len(buf) != expected:
            raise ValueError(f"bad length: {len(buf)} != {expected}")
        pos = 0

        def read_item():
            nonlocal pos
            item = item_from_bytes(buf[pos: pos + item_size])
            if item is None:
                raise ValueError("invalid item encoding")
            pos += item_size
            return item

        root = read_item()
        branch = [[read_item() for _ in range(arity)] for _ in range(height)]
        positions = []
        for _ in range(height):
            positions.append(int.from_bytes(buf[pos: pos + 4], "little"))
            pos += 4
        return cls(None, root=root, branch=branch, positions=positions,
                   item_type=item_type, height=height, arity=arity)
