"""Dinic max-flow / min-cut on small graphs (used per connected component of the
pruned overlay, paper §4.4–4.5). Capacities are floats; INF marks uncuttable
(original overlay) edges."""
from __future__ import annotations

INF = float("inf")


class Dinic:
    def __init__(self, n: int):
        self.n = n
        self.to: list[int] = []
        self.cap: list[float] = []
        self.head: list[list[int]] = [[] for _ in range(n)]

    def add_edge(self, u: int, v: int, cap: float) -> None:
        self.head[u].append(len(self.to))
        self.to.append(v)
        self.cap.append(cap)
        self.head[v].append(len(self.to))
        self.to.append(u)
        self.cap.append(0.0)

    def _bfs(self, s: int, t: int) -> bool:
        self.level = [-1] * self.n
        self.level[s] = 0
        q = [s]
        while q:
            nq = []
            for u in q:
                for eid in self.head[u]:
                    v = self.to[eid]
                    if self.cap[eid] > 1e-12 and self.level[v] < 0:
                        self.level[v] = self.level[u] + 1
                        nq.append(v)
            q = nq
        return self.level[t] >= 0

    def _dfs(self, u: int, t: int, f: float) -> float:
        if u == t:
            return f
        while self.it[u] < len(self.head[u]):
            eid = self.head[u][self.it[u]]
            v = self.to[eid]
            if self.cap[eid] > 1e-12 and self.level[v] == self.level[u] + 1:
                d = self._dfs(v, t, min(f, self.cap[eid]))
                if d > 1e-12:
                    self.cap[eid] -= d
                    self.cap[eid ^ 1] += d
                    return d
            self.it[u] += 1
        return 0.0

    def max_flow(self, s: int, t: int) -> float:
        flow = 0.0
        while self._bfs(s, t):
            self.it = [0] * self.n
            while True:
                f = self._dfs(s, t, INF)
                if f <= 1e-12:
                    break
                flow += f
        return flow

    def reachable_from(self, s: int) -> list[bool]:
        """Nodes reachable from s in the residual graph (defines the min cut)."""
        seen = [False] * self.n
        seen[s] = True
        q = [s]
        while q:
            u = q.pop()
            for eid in self.head[u]:
                v = self.to[eid]
                if self.cap[eid] > 1e-12 and not seen[v]:
                    seen[v] = True
                    q.append(v)
        return seen
