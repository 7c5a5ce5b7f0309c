// World: the scene-compiler entry point. Owns the authored scene, runs the
// per-tick update pipeline (animation -> scene-graph flatten -> skinning ->
// BLAS -> TLAS -> flat buffer emit) and exposes the 10 flat output buffers.
// Capability parity: reference rust-shader-tools/src/lib.rs (World) and
// rebuilder.rs / render_buffers.rs.
#pragma once
#include <cstdint>
#include <string>
#include <vector>

#include "geometry.h"
#include "scene_types.h"

namespace wrt {

// Flat output vectors — the contract consumed by the JAX path tracer
// (reference render_buffers.rs; exact layouts in SURVEY.md §2.2).
struct RenderBuffers {
  std::vector<float> vertices;        // xyzw, w=1 (post skinning)
  std::vector<float> normals;         // xyzw, w=0
  std::vector<float> uvs;             // uv
  std::vector<uint32_t> mesh_topology;  // stride 20: v0,v1,v2,geom_idx + 16 attr bit-floats
  std::vector<float> blas_nodes;      // 8 f32 per node, all geometries merged
  std::vector<float> tlas_nodes;      // 8 f32 per node
  std::vector<float> instances;       // 36 f32 per instance (TLAS-sorted)
  std::vector<uint32_t> lights;       // [instance_idx, tri_idx] pairs
  std::vector<uint32_t> draw_commands;  // [v_count, 1, v_start, i] per instance
  std::vector<float> camera_data;     // 24 f32

  void clear_geometry() {
    vertices.clear();
    normals.clear();
    uvs.clear();
    mesh_topology.clear();
    blas_nodes.clear();
  }
};

class World {
 public:
  World(const std::string& scene_name, const std::string* obj_source,
        const uint8_t* glb_data, size_t glb_len);

  // Per-tick update (reference lib.rs:149-271).
  void update(float time);
  void update_camera(float width, float height);

  size_t animation_count() const { return scene_.animations.size(); }
  const std::string& animation_name(size_t i) const;
  void set_animation(size_t i);
  bool load_animation_glb(const uint8_t* data, size_t len);

  size_t texture_count() const { return scene_.textures.size(); }
  const std::vector<uint8_t>& texture(size_t i) const { return scene_.textures[i]; }

  const RenderBuffers& buffers() const { return buffers_; }

 private:
  void apply_animation(size_t anim_idx, float time);
  void update_node_global(size_t node_idx, const Mat4& parent,
                          std::vector<Mat4>& globals);
  // Skinning + per-geometry BLAS + topology/light packing
  // (reference rebuilder.rs:8-186). Returns per-geometry emissive triangle
  // lists and (topo_start, topo_count) ranges.
  void rebuild_geometry(const std::vector<Mat4>& globals,
                        std::vector<std::vector<uint32_t>>& emissive_lists,
                        std::vector<std::pair<uint32_t, uint32_t>>& geom_ranges);

  // Per-geometry build cache. The authored geometry set is immutable after
  // construction (update() only changes node transforms + skin poses), so:
  //  - non-skinned geometries' outputs are tick-invariant: cached verbatim
  //    and spliced (with index rebasing) every tick;
  //  - skinned geometries keep their FIRST-pose BLAS topology (leaf order,
  //    skip pointers) and per tick only re-skin vertices and REFIT node
  //    AABBs bottom-up — O(V + T) instead of a full binned-SAH rebuild.
  // The reference rebuilds everything per tick (rebuilder.rs:8-186) against
  // a 60 fps WASM budget; refit keeps images identical (the BLAS only
  // accelerates: AABBs stay exact over the same leaf set) while cutting the
  // host tick from O(T log T) SAH to a memcpy + skin + refit.
  struct GeomCache {
    bool valid = false;
    std::vector<float> v_vec4, n_vec4, uv_vec2;  // geometry-local
    std::vector<float> nodes;       // 8 f32/node; leaf data + skips LOCAL
    std::vector<uint32_t> topo;     // stride-20 records, v-indices LOCAL
    std::vector<uint32_t> emissive; // LOCAL topo indices
  };
  void refit_cached_blas(GeomCache& cache);

  RenderBuffers buffers_;
  SceneData scene_;
  std::vector<GeomCache> geom_cache_;
  std::vector<uint32_t> blas_root_offsets_;
  std::vector<AABB> instance_blas_aabbs_;
  std::vector<Instance> raw_instances_;
  size_t active_anim_index_ = 0;
};

}  // namespace wrt
